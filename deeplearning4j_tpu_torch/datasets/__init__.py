"""DataSet iterators: synchronous, sampled, replayed, and the
asynchronous prefetcher that stages batches on the device; the MNIST,
Iris, CIFAR-10, LFW and Curves iterators; the DataVec record readers and
their iterators. The native C++ loader is ``datasets.native_loader``."""

from .iterators import (ArrayDataSetIterator, AsyncDataSetIterator,
                        DataSetIterator, ListDataSetIterator,
                        MultipleEpochsIterator, SamplingDataSetIterator,
                        as_iterator)
from .mnist import IrisDataSetIterator, MnistDataSetIterator
from .fetchers import (CifarDataSetIterator, CurvesDataSetIterator,
                       LFWDataSetIterator)
from .datavec import (CollectionRecordReader, CollectionSequenceRecordReader,
                      CSVRecordReader, RecordReader,
                      RecordReaderDataSetIterator,
                      RecordReaderMultiDataSetIterator,
                      SequenceRecordReaderDataSetIterator)

__all__ = ["DataSetIterator", "ListDataSetIterator", "ArrayDataSetIterator",
           "AsyncDataSetIterator", "MultipleEpochsIterator",
           "SamplingDataSetIterator", "as_iterator", "MnistDataSetIterator",
           "IrisDataSetIterator", "CifarDataSetIterator",
           "LFWDataSetIterator", "CurvesDataSetIterator", "RecordReader",
           "CSVRecordReader",
           "CollectionRecordReader", "CollectionSequenceRecordReader",
           "RecordReaderDataSetIterator",
           "SequenceRecordReaderDataSetIterator",
           "RecordReaderMultiDataSetIterator"]
