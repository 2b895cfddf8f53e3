"""PyTorch port, evaluation on the CPU: the port's own ``eval/`` package
(Evaluation, RegressionEvaluation, ROC, ROCBinary, ROCMultiClass,
EvaluationBinary, EvaluationWithMetadata) against the JAX package's on the
same seeded numpy inputs — counts exact, statistics to 1e-12 — the
reporting breadth of ``tests/test_eval_breadth.py`` on the port's classes,
and the sequential network's ``evaluate*`` and ``score_examples`` against
the JAX network with the same weights (1e-5).

Tolerances: the evaluation classes are the same numpy code on the same
arrays, so their statistics agree to 1e-12 (summation order only); the
networks' outputs agree to f32 rounding (1e-5)."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import eval as jeval
from deeplearning4j_tpu.nn import InputType as JaxInputType
from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JaxOut
from deeplearning4j_tpu.ops.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu_torch import eval as teval
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.ops.dataset import DataSet
from deeplearning4j_tpu_torch.ops.transfer import fetch_counts
from deeplearning4j_tpu_torch.utils import network_from_numpy

STAT = dict(rtol=1e-12, atol=1e-12)
TOL = dict(rtol=1e-5, atol=1e-5)


def _cls_batch(n, c, seed, t=None):
    """One-hot labels and softmax-like probabilities, [N, C] or [N, T, C],
    and an [N, T] mask for sequences."""
    rng = np.random.default_rng(seed)
    shape = (n,) if t is None else (n, t)
    labels = np.eye(c)[rng.integers(0, c, shape)]
    logits = rng.normal(size=shape + (c,)) + 1.5 * labels
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    mask = None if t is None else (rng.random(shape) > 0.3).astype(
        np.float32)
    return labels, probs, mask


# ------------------------------------------------------------ Evaluation
@pytest.mark.parametrize("t", [None, 5], ids=["rows", "sequence"])
@pytest.mark.parametrize("top_n", [1, 3])
def test_evaluation_matches_jax(t, top_n):
    """Two batches through both packages' Evaluation: the confusion matrix
    and top-N count exactly equal, every statistic to 1e-12, the stats
    text identical."""
    evs = [mod.Evaluation(top_n=top_n, labels=["a", "b", "c", "d", "e"])
           for mod in (jeval, teval)]
    for seed in (1, 2):
        labels, probs, mask = _cls_batch(40, 5, seed, t)
        for ev in evs:
            ev.eval(labels, probs, mask=mask)
    j, p = evs
    np.testing.assert_array_equal(p.confusion, j.confusion)
    assert (p.total, p.top_n_correct) == (j.total, j.top_n_correct)
    for name in ("accuracy", "top_n_accuracy", "false_alarm_rate"):
        np.testing.assert_allclose(getattr(p, name)(), getattr(j, name)(),
                                   **STAT)
    for c in [None] + list(range(5)):
        for name in ("precision", "recall", "f1", "g_measure",
                     "matthews_correlation", "false_positive_rate",
                     "false_negative_rate"):
            np.testing.assert_allclose(getattr(p, name)(c),
                                       getattr(j, name)(c), **STAT)
        assert p.true_positives(c) == j.true_positives(c)
        assert p.false_negatives(c) == j.false_negatives(c)
    assert p.stats() == j.stats()
    assert p.confusion_to_string() == j.confusion_to_string()


def test_regression_evaluation_matches_jax():
    rng = np.random.default_rng(3)
    evs = [mod.RegressionEvaluation() for mod in (jeval, teval)]
    for _ in range(2):
        labels = rng.normal(size=(30, 3))
        preds = labels + 0.3 * rng.normal(size=(30, 3))
        for ev in evs:
            ev.eval(labels, preds)
    j, p = evs
    assert p.num_columns() == j.num_columns() == 3
    for col in range(3):
        for name in ("mean_squared_error", "mean_absolute_error",
                     "root_mean_squared_error", "r_squared",
                     "pearson_correlation", "relative_squared_error"):
            np.testing.assert_allclose(getattr(p, name)(col),
                                       getattr(j, name)(col), **STAT)
    np.testing.assert_allclose(p.average_mean_squared_error(),
                               j.average_mean_squared_error(), **STAT)
    assert p.stats() == j.stats()


@pytest.mark.parametrize("steps", [0, 20], ids=["exact", "thresholds"])
def test_roc_family_matches_jax(steps):
    """ROC (one column), ROCBinary (per column) and ROCMultiClass
    (one-vs-all): the same AUC and AUPRC, and the same curve."""
    labels, probs, _ = _cls_batch(60, 4, 5)
    binary = labels[:, :1]
    j = jeval.ROC(steps)
    p = teval.ROC(steps)
    for ev in (j, p):
        ev.eval(binary, probs[:, :1])
    np.testing.assert_allclose(p.calculate_auc(), j.calculate_auc(), **STAT)
    np.testing.assert_allclose(p.calculate_auprc(), j.calculate_auprc(),
                               **STAT)
    for a, b in zip(p.get_roc_curve(), j.get_roc_curve()):
        np.testing.assert_allclose(a, b, **STAT)
    jb, pb = jeval.ROCBinary(steps), teval.ROCBinary(steps)
    jm, pm = jeval.ROCMultiClass(steps), teval.ROCMultiClass(steps)
    for ev in (jb, pb, jm, pm):
        ev.eval(labels, probs)
    for c in range(4):
        np.testing.assert_allclose(pb.calculate_auc(c), jb.calculate_auc(c),
                                   **STAT)
        np.testing.assert_allclose(pm.calculate_auc(c), jm.calculate_auc(c),
                                   **STAT)
    np.testing.assert_allclose(pm.calculate_average_auc(),
                               jm.calculate_average_auc(), **STAT)


def test_evaluation_binary_and_metadata_match_jax():
    rng = np.random.default_rng(6)
    labels = (rng.random((25, 3)) > 0.5).astype(np.float32)
    preds = np.clip(labels * 0.6 + 0.5 * rng.random((25, 3)), 0, 1)
    jb, pb = (mod.EvaluationBinary(threshold=0.55, label_names=list("xyz"))
              for mod in (jeval, teval))
    for ev in (jb, pb):
        ev.eval(labels, preds)
    for col in range(3):
        for name in ("true_positives", "true_negatives", "false_positives",
                     "false_negatives", "total_count"):
            assert getattr(pb, name)(col) == getattr(jb, name)(col)
        for name in ("accuracy", "precision", "recall", "f1",
                     "matthews_correlation", "g_measure"):
            np.testing.assert_allclose(getattr(pb, name)(col),
                                       getattr(jb, name)(col), **STAT)
    assert pb.stats() == jb.stats()
    cls, probs, _ = _cls_batch(12, 3, 7)
    meta = [f"record-{i}" for i in range(12)]
    jm, pm = (mod.EvaluationWithMetadata() for mod in (jeval, teval))
    for ev in (jm, pm):
        ev.eval(cls, probs, metadata=meta)
    assert [(x.actual, x.predicted, x.metadata) for x in pm.predictions] == \
        [(x.actual, x.predicted, x.metadata) for x in jm.predictions]
    assert [x.metadata for x in pm.get_prediction_errors()] == \
        [x.metadata for x in jm.get_prediction_errors()]
    np.testing.assert_array_equal(pm.evaluation.confusion,
                                  jm.evaluation.confusion)
    assert pm.stats() == jm.stats()


# ------------------------------------------ reporting breadth, port's classes
def _filled(mod):
    ev = mod.Evaluation(labels=["cat", "dog", "bird"])
    ev.eval(np.eye(3)[[0, 0, 0, 1, 1, 2, 2, 2, 2, 2]],
            np.eye(3)[[0, 0, 1, 1, 1, 2, 2, 2, 0, 1]])
    return ev


def _breadth_counts(ev):
    assert ev.true_positives() == {0: 2, 1: 2, 2: 3}
    assert ev.false_negatives(0) == 1 and ev.false_positives(1) == 2
    assert ev.true_negatives(0) == 6
    assert ev.positive() == {0: 3, 1: 2, 2: 5}
    assert ev.negative()[2] == 5 and ev.class_count(2) == 5
    assert ev.false_positive_rate(0) == pytest.approx(1 / 7)
    assert ev.false_negative_rate(2) == pytest.approx(2 / 5)


def _breadth_mcc(ev):
    want = (2 * 6 - 1 * 1) / np.sqrt((2 + 1) * (2 + 1) * (6 + 1) * (6 + 1))
    assert ev.matthews_correlation(0) == pytest.approx(want)
    assert ev.matthews_correlation() == pytest.approx(
        np.mean([ev.matthews_correlation(i) for i in range(3)]))


def _breadth_fbeta(ev):
    p, r = ev.precision(2), ev.recall(2)
    assert ev.g_measure(2) == pytest.approx(np.sqrt(p * r))
    assert ev.f_beta(1.0, 2) == pytest.approx(ev.f1(2))
    assert ev.f_beta(2.0, 2) == pytest.approx(5 * p * r / (4 * p + r))


def _breadth_render(ev):
    s = ev.stats()
    assert "MCC" in s and "G-measure" in s and "Per-class statistics" in s
    assert "cat" in s and "bird" in s
    assert "Predicted:" in ev.confusion_to_string()


def _breadth_merge(ev):
    ev.merge(_filled(teval))
    assert ev.total == 20 and ev.true_positives(2) == 6


@pytest.mark.parametrize("check", [_breadth_counts, _breadth_mcc,
                                   _breadth_fbeta, _breadth_render,
                                   _breadth_merge],
                         ids=lambda f: f.__name__[9:])
def test_evaluation_breadth_on_the_port(check):
    """test_eval_breadth.py's Evaluation cases on the port's class."""
    check(_filled(teval))


def test_incremental_eval_and_binary_breadth_on_the_port():
    ev = teval.Evaluation(num_classes=2)
    for a, p in [(0, 0), (0, 1), (1, 1), (1, 1)]:
        ev.eval(a, p)
    assert ev.accuracy() == pytest.approx(3 / 4)
    ev.add_to_confusion(1, 0, count=2)
    assert ev.false_negatives(1) == 2
    ev2 = teval.Evaluation(num_classes=2)
    ev2.eval(np.eye(2)[[0, 1]], np.eye(2)[[0, 0]])
    assert "never predicted" in ev2.stats()
    assert "never predicted" not in ev2.stats(suppress_warnings=True)
    eb = teval.EvaluationBinary(label_names=["x", "y"])
    eb.eval(np.array([[1, 0], [1, 1], [0, 1], [0, 0], [1, 0]]),
            np.array([[0.9, 0.2], [0.8, 0.4], [0.3, 0.9], [0.1, 0.6],
                      [0.4, 0.1]]))
    assert (eb.true_positives(0), eb.false_negatives(0),
            eb.true_negatives(0)) == (2, 1, 2)
    assert eb.false_positive_rate(1) == pytest.approx(1 / 3)
    empty = teval.EvaluationBinary()
    empty.merge(eb)
    assert empty.total_count(1) == 5


# --------------------------------------------- the sequential network's API
def _mln_pair(n_out, loss, act, seed=7):
    """A 4 → 6 → n_out dense net in both packages, the JAX net's weights
    in the port's (CPU, f32)."""
    jconf = (JaxNNC.Builder().seed(seed).learning_rate(0.1).updater("sgd")
             .weight_init("xavier").activation("tanh").l2(1e-3)
             .list()
             .layer(JaxDense(n_out=6))
             .layer(JaxOut(n_out=n_out, loss=loss, activation=act))
             .set_input_type(JaxInputType.feed_forward(4)).build())
    jnet = JaxNet(jconf).init()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    arrays = [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params]
    return jnet, network_from_numpy(conf, arrays, device="cpu")


def _batches(n_out, regression, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        x = rng.normal(size=(16, 4)).astype(np.float32)
        y = rng.normal(size=(16, n_out)).astype(np.float32) if regression \
            else np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, 16)]
        out.append((x, y))
    return out


def test_mln_evaluate_matches_jax():
    """evaluate, evaluate_roc and evaluate_roc_multi_class over three
    batches: the same counts and AUCs; one readback a batch."""
    jnet, net = _mln_pair(3, "mcxent", "softmax")
    data = _batches(3, False)
    jds = [JaxDataSet(x, y) for x, y in data]
    tds = [DataSet(x, y) for x, y in data]
    before = fetch_counts("multilayer.eval")["multilayer.eval"]
    ev, jev = net.evaluate(tds), jnet.evaluate(jds)
    assert fetch_counts("multilayer.eval")["multilayer.eval"] - before == 3
    np.testing.assert_array_equal(ev.confusion, jev.confusion)
    np.testing.assert_allclose(ev.accuracy(), jev.accuracy(), **STAT)
    roc_m = net.evaluate_roc_multi_class(tds)
    jroc_m = jnet.evaluate_roc_multi_class(jds)
    for c in range(3):
        np.testing.assert_allclose(roc_m.calculate_auc(c),
                                   jroc_m.calculate_auc(c), **TOL)
    jnet2, net2 = _mln_pair(2, "mcxent", "softmax", seed=8)
    data2 = _batches(2, False, seed=12)
    roc = net2.evaluate_roc([DataSet(x, y) for x, y in data2])
    jroc = jnet2.evaluate_roc([JaxDataSet(x, y) for x, y in data2])
    np.testing.assert_allclose(roc.calculate_auc(), jroc.calculate_auc(),
                               **TOL)


def test_mln_evaluate_regression_matches_jax():
    jnet, net = _mln_pair(3, "mse", "identity")
    data = _batches(3, True)
    r = net.evaluate_regression([DataSet(x, y) for x, y in data])
    jr = jnet.evaluate_regression([JaxDataSet(x, y) for x, y in data])
    for col in range(3):
        np.testing.assert_allclose(r.mean_squared_error(col),
                                   jr.mean_squared_error(col), **TOL)
        np.testing.assert_allclose(r.r_squared(col), jr.r_squared(col),
                                   **TOL)


@pytest.mark.parametrize("add_reg", [False, True])
def test_mln_score_examples_matches_jax(add_reg):
    """Per-example losses against the JAX net's, and their mean against
    the port's own score (the l2 penalty added once per example with
    ``add_regularization``)."""
    jnet, net = _mln_pair(3, "mcxent", "softmax")
    x, y = _batches(3, False)[0]
    per = net.score_examples(DataSet(x, y), add_regularization=add_reg)
    want = jnet.score_examples(JaxDataSet(x, y), add_regularization=add_reg)
    assert per.shape == (16,) and per.dtype == np.float64
    np.testing.assert_allclose(per, want, **TOL)
    if not add_reg:
        np.testing.assert_allclose(per.mean() +
                                   float(net._forward(
                                       net.params, net._inference_state(),
                                       torch.from_numpy(x), train=False,
                                       rng=None)[2]),
                                   net.score(DataSet(x, y)), **TOL)


def test_mln_clone_is_independent():
    _, net = _mln_pair(3, "mcxent", "softmax")
    x, y = _batches(3, False)[0]
    net.fit(DataSet(x, y))
    twin = net.clone()
    np.testing.assert_array_equal(twin.params_flat(), net.params_flat())
    assert twin.iteration == net.iteration
    np.testing.assert_allclose(twin.output(x), net.output(x), rtol=0, atol=0)
    twin.fit(DataSet(x, y))
    assert not np.array_equal(twin.params_flat(), net.params_flat())
    net.fit(DataSet(x, y))
    np.testing.assert_array_equal(twin.params_flat(), net.params_flat())
