"""The GravesLSTM character RNN (the JAX package's ``models/char_rnn.py``):
two GravesLSTM layers and a softmax RnnOutputLayer trained with rmsprop
and l2 through truncated BPTT, and ``CharacterIterator``, which cuts one-hot
sequences from a text and samples from a trained net through
``rnn_time_step``."""

from __future__ import annotations

import numpy as np

from ..datasets.iterators import DataSetIterator
from ..nn.conf.config import MultiLayerConfiguration, NeuralNetConfiguration
from ..nn.conf.input_type import InputType
from ..nn.conf.layers import GravesLSTM, RnnOutputLayer
from ..ops.dataset import DataSet


def char_rnn_conf(vocab_size: int, hidden: int = 200, layers: int = 2,
                  learning_rate: float = 0.1, tbptt_length: int = 50,
                  seed: int = 12345) -> MultiLayerConfiguration:
    """The configuration the JAX package builds (same JSON).
    ``tbptt_length=0`` trains on whole sequences."""
    b = (NeuralNetConfiguration.Builder()
         .seed(seed)
         .learning_rate(learning_rate)
         .updater("rmsprop").rms_decay(0.95)
         .weight_init("xavier")
         .regularization(True).l2(0.001)
         .list())
    for _ in range(layers):
        b.layer(GravesLSTM(n_out=hidden, activation="tanh"))
    b.layer(RnnOutputLayer(n_out=vocab_size, loss="mcxent",
                           activation="softmax"))
    return (b.backprop_type("truncated_bptt")
            .tbptt_fwd_length(tbptt_length).tbptt_back_length(tbptt_length)
            .set_input_type(InputType.recurrent(vocab_size))
            .build())


class CharacterIterator(DataSetIterator):
    """One-hot character sequences from a text: each pass shuffles the
    sequence starts (numpy's generator from ``seed``) and yields batches of
    (chars, next chars)."""

    def __init__(self, text: str, seq_length: int = 50, batch_size: int = 32,
                 seed: int = 0):
        self.chars = sorted(set(text))
        self.char_to_idx = {c: i for i, c in enumerate(self.chars)}
        self.encoded = np.array([self.char_to_idx[c] for c in text], np.int32)
        self.seq_length = int(seq_length)
        self._bs = int(batch_size)
        self._rng = np.random.default_rng(seed)

    @property
    def vocab_size(self) -> int:
        return len(self.chars)

    def __iter__(self):
        n_seqs = (len(self.encoded) - 1) // self.seq_length
        starts = np.arange(n_seqs) * self.seq_length
        self._rng.shuffle(starts)
        eye = np.eye(self.vocab_size, dtype=np.float32)
        for i in range(0, n_seqs - n_seqs % self._bs or n_seqs, self._bs):
            batch_starts = starts[i:i + self._bs]
            if len(batch_starts) == 0:
                return
            feats = np.stack([eye[self.encoded[s:s + self.seq_length]]
                              for s in batch_starts])
            labels = np.stack([eye[self.encoded[s + 1:s + 1 + self.seq_length]]
                               for s in batch_starts])
            yield DataSet(feats, labels)

    def batch_size(self) -> int:
        return self._bs

    def sample(self, net, seed_char: str, length: int = 100,
               temperature: float = 1.0, rng_seed: int = 0) -> str:
        """``length`` characters after ``seed_char``, one ``rnn_time_step``
        call (one readback) each, drawn with numpy's generator from
        ``rng_seed`` exactly as the JAX package draws them: the same
        probabilities give the same characters."""
        rng = np.random.default_rng(rng_seed)
        net.rnn_clear_previous_state()
        v = self.vocab_size
        idx = self.char_to_idx[seed_char]
        out_chars = [seed_char]
        for _ in range(length):
            x = np.zeros((1, v), np.float32)
            x[0, idx] = 1.0
            probs = np.asarray(net.rnn_time_step(x)[0], np.float64)
            if temperature != 1.0:
                logp = np.log(np.maximum(probs, 1e-12)) / temperature
                probs = np.exp(logp - logp.max())
            probs = probs / probs.sum()
            idx = int(rng.choice(v, p=probs))
            out_chars.append(self.chars[idx])
        return "".join(out_chars)
