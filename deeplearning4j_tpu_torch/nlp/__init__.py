"""NLP/embeddings (reference deeplearning4j-nlp-parent; SURVEY.md §2.5):
SequenceVectors engine, Word2Vec/ParagraphVectors/GloVe, vocab + Huffman,
tokenization pipeline, BoW/TF-IDF, word-vector serializers. The counterpart
of the JAX package's ``nlp``: the trainers' tables live on ``device``
(``None``: the CUDA card); the text tier is the same host Python."""

from .vocab import VocabCache, VocabConstructor, VocabWord
from .huffman import build_huffman, apply_huffman, pad_codes
from .sequence_vectors import SequenceVectors, InMemoryLookupTable
from .word2vec import Word2Vec, ParagraphVectors
from .glove import Glove
from .tokenization import (DefaultTokenizerFactory, NGramTokenizerFactory,
                           CommonPreprocessor, CollectionSentenceIterator,
                           LineSentenceIterator, LabelAwareSentenceIterator,
                           StopWords)
from .vectorizers import (BagOfWordsVectorizer, TfidfVectorizer,
                          WordVectorSerializer, StaticWord2Vec)
from .word2vec_iterator import Word2VecDataSetIterator, WindowDataSetIterator
from .cjk import JapaneseTokenizerFactory, KoreanTokenizerFactory
from .lattice import LatticeJapaneseTokenizerFactory
from .klattice import LatticeKoreanTokenizerFactory
from .treeparser import (Tree, TreeParser, TreeVectorizer,
                         BinarizeTreeTransformer, CollapseUnaries,
                         HeadWordFinder)
from .sentiment import SentimentScorer
from .annotators import (Annotation, AnnotatedDocument, SentenceAnnotator,
                         TokenizerAnnotator, PosTagger, StemmerAnnotator,
                         AnnotatorPipeline)
from .distributed import DistributedWord2Vec

__all__ = ["VocabCache", "VocabConstructor", "VocabWord", "build_huffman",
           "apply_huffman", "pad_codes", "SequenceVectors",
           "InMemoryLookupTable", "Word2Vec", "ParagraphVectors", "Glove",
           "DefaultTokenizerFactory", "NGramTokenizerFactory",
           "CommonPreprocessor", "CollectionSentenceIterator",
           "LineSentenceIterator", "LabelAwareSentenceIterator", "StopWords",
           "BagOfWordsVectorizer", "TfidfVectorizer", "WordVectorSerializer",
           "StaticWord2Vec", "Word2VecDataSetIterator",
           "WindowDataSetIterator", "JapaneseTokenizerFactory",
           "LatticeJapaneseTokenizerFactory",
           "LatticeKoreanTokenizerFactory",
           "Tree", "TreeParser", "TreeVectorizer",
           "BinarizeTreeTransformer", "CollapseUnaries", "HeadWordFinder",
           "SentimentScorer",
           "KoreanTokenizerFactory", "Annotation", "AnnotatedDocument",
           "SentenceAnnotator", "TokenizerAnnotator", "PosTagger",
           "StemmerAnnotator", "AnnotatorPipeline", "DistributedWord2Vec"]
