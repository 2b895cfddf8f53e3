"""PyTorch port, SwinV2 on the CPU: the tiny SwinV2 net of the benchmark's
``swinv2-base-w16-256`` configuration (its ``tiny`` sizes: a shifted
stage and a clipped one) trained by ``ComputationGraph.fit_batch`` in
float32 against the plain reference ``portbench/reference/swinv2.py`` on
the same seeded weights (the loss, every leaf's first gradient, every
leaf after 3 Adam steps); the plain biased attention, forward and
backward with dbias, and its autograd Function, against autograd through
a materialised softmax; the coordinate table, the relative index and the
shift mask against hand-built cases and against the reference's own
construction; the biased kernels' refusals; the ``dl4j.swin.*`` spans;
and serde round trips of the new layer configurations."""

import copy
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from deeplearning4j_tpu_torch.kernels import shortseq_attention as ss  # noqa: E402
from deeplearning4j_tpu_torch.models import swinv2_conf  # noqa: E402
from deeplearning4j_tpu_torch.nn import helpers  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf.layers import (  # noqa: E402
    ChannelLayerNorm, PatchMerging, SwinV2Block)
from deeplearning4j_tpu_torch.nn.conf.layers import swin  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf.serde import (  # noqa: E402
    from_jsonable, to_jsonable)
from deeplearning4j_tpu_torch.nn.graph.graph_config import (  # noqa: E402
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.ops.dataset import DataSet  # noqa: E402
from portbench import feeds, harness, train  # noqa: E402
from portbench.reference import common  # noqa: E402
from portbench.reference import swinv2 as ref  # noqa: E402

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def _tiny_cfg():
    cfg = copy.deepcopy(harness.load_json(
        ROOT / "portbench" / "configs" / "swinv2-base-w16-256.json"))
    cfg.update(cfg.pop("tiny"))
    cfg["training"]["compute_dtype"] = "float32"
    return cfg


def _tiny_batches(cfg, steps=3, batch=4):
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn(steps, batch, cfg["height"], cfg["width"],
                    cfg["channels"], generator=g)
    y = torch.randint(0, cfg["num_classes"], (steps, batch), generator=g)
    return [(x[i].numpy(), y[i].to(torch.int32).numpy())
            for i in range(steps)]


@pytest.fixture(scope="module")
def trained():
    """The program and the reference, 3 Adam steps each from the same
    seeded weights on the same batches: (program readings, reference
    readings), each {"loss": [...], "grads": {leaf: tensor},
    "params": {leaf: tensor}}."""
    cfg = _tiny_cfg()
    batches = _tiny_batches(cfg)
    net = train.build_program(cfg, CPU)
    train.load_weights(net, cfg, SEED, CPU)
    upd = common.updater_of(cfg)
    losses, grads = [], {}
    for i, (x, y) in enumerate(batches):
        net.fit_batch(DataSet(x, y))
        losses.append(float(net.score_value))
        if i == 0:
            grads = {f"{v}.{k}": upd.first_gradient(s).clone()
                     for v, st in net.updater_state.items()
                     for k, s in st.items()}
    got = {"loss": losses, "grads": grads,
           "params": {f"{v}.{k}": p.detach().clone()
                      for v, ps in net.params.items()
                      for k, p in ps.items()}}
    params = common.make_params(ref.param_specs(cfg),
                                feeds.sub_seed(SEED, "weights"), CPU)
    losses, grads = [], {}
    opt = {v: {k: upd.init(p) for k, p in ps.items()}
           for v, ps in params.items()}
    for i, (x, y) in enumerate(batches):
        leaves = {v: {k: p.detach().requires_grad_(True)
                      for k, p in ps.items()} for v, ps in params.items()}
        loss, _ = ref.loss(cfg, leaves, {}, (torch.from_numpy(x),
                                             torch.from_numpy(y)))
        flat = [(v, k) for v, ps in leaves.items() for k in ps]
        gs = torch.autograd.grad(loss, [leaves[v][k] for v, k in flat])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (v, k), gr in zip(flat, gs):
                if i == 0:
                    grads[f"{v}.{k}"] = gr.clone()
                upd.step(params[v][k], gr, opt[v][k], float(i))
    want = {"loss": losses, "grads": grads,
            "params": {f"{v}.{k}": p.clone() for v, ps in params.items()
                       for k, p in ps.items()}}
    return got, want


def _rel(a, b, floor=0.0):
    return ((a - b).norm() / max(b.norm().item(), floor, 1e-30)).item()


def test_tiny_net_loss_matches_the_reference(trained):
    """Both compute the same float32 function; the sums run in other
    orders (the windows' products, the LayerNorms' statistics), ~1e-7."""
    got, want = trained
    for a, b in zip(got["loss"], want["loss"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert got["loss"][0] > 0


def test_tiny_net_every_leaf_gradient_matches_the_reference(trained):
    """Every leaf's first gradient (as Adam took it) within 1e-4 relative
    L2, or 1e-4 of the median leaf's norm for a leaf whose gradient is
    near zero (a bias behind a LayerNorm): float32 in other orders."""
    got, want = trained
    assert set(got["grads"]) == set(want["grads"])
    med = float(np.median([g.norm().item() for g in want["grads"].values()]))
    for name, g in want["grads"].items():
        assert _rel(got["grads"][name], g, floor=med) <= 1e-4, name
        assert torch.isfinite(got["grads"][name]).all(), name


def test_tiny_net_leaves_after_three_adam_steps_match(trained):
    """Every leaf after 3 Adam steps: its change from the start within
    1e-3 relative L2 of the reference's. Adam divides each element's
    moment by its own √v, so an element whose gradient is near zero moves
    by a larger share of its rounding than the gradients differ."""
    got, want = trained
    start = common.make_params(ref.param_specs(_tiny_cfg()),
                               feeds.sub_seed(SEED, "weights"), CPU)
    first = {f"{v}.{k}": p for v, ps in start.items() for k, p in ps.items()}
    for name, p in want["params"].items():
        moved = p - first[name]
        assert moved.norm() > 0, name
        assert _rel(got["params"][name] - first[name], moved) <= 1e-3, name


# ------------------------------------------------- plain biased attention
def _materialised(q3, k3, v3, bias, h, scale):
    idx = ss.bias_index(q3.shape[0], h, bias.shape[0])
    s = torch.einsum("btd,bsd->bts", q3, k3) * scale + \
        bias.reshape(-1, *bias.shape[2:])[idx]
    return torch.softmax(s, dim=-1) @ v3


@pytest.mark.parametrize("p", [1, 3])
def test_plain_biased_attention_matches_autograd(p):
    """attention_fwd_plain / attention_bwd_plain with a bias (and the
    Function on them) against autograd through a materialised softmax in
    float64; the plain functions compute in float32 (~1e-6)."""
    g = torch.Generator().manual_seed(p)
    b, h, t, d = 6, 2, 12, 8
    q3, k3, v3, do = (torch.randn(b * h, t, d, generator=g,
                                  dtype=torch.float64) for _ in range(4))
    bias = torch.randn(p, h, t, t, generator=g, dtype=torch.float64) * 3
    leaves = [x.clone().requires_grad_(True) for x in (q3, k3, v3, bias)]
    o = _materialised(*leaves[:3], leaves[3], h, 0.6)
    want = torch.autograd.grad(o, leaves, do)
    o_p, lse = ss.attention_fwd_plain(q3, k3, v3, None, h, False, 0.6, bias)
    assert (o_p - o).abs().max() <= 1e-5
    got = ss.attention_bwd_plain(q3, k3, v3, None, h, False, o_p, lse, do,
                                 None, 0.6, bias)
    assert got[3].shape == bias.shape
    for x, y in zip(got, want):
        assert (x.double() - y).abs().max() <= 1e-5 * max(1.0, y.abs().max())
    leaves = [x.clone().requires_grad_(True) for x in (q3, k3, v3, bias)]
    o_f = ss.BiasedShortAttention.apply(*leaves, h, 0.6)
    for x, y in zip(torch.autograd.grad(o_f, leaves, do), want):
        assert (x.double() - y).abs().max() <= 1e-5 * max(1.0, y.abs().max())


def test_unit_rows_matches_normalize_and_its_gradient():
    """UnitRows (SwinV2's q̂ / k̂ with the temperature a head) against
    F.normalize times the factor, forward and backward, in float64."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(5, 7, 3, 8, generator=g, dtype=torch.float64)
    s = torch.rand(3, generator=g, dtype=torch.float64) + 0.5
    assert torch.autograd.gradcheck(swin.UnitRows.apply,
                                    (x.requires_grad_(True),
                                     s.requires_grad_(True)))
    want = torch.nn.functional.normalize(x, dim=-1) * s[:, None]
    assert torch.allclose(swin.UnitRows.apply(x, s), want, atol=1e-6)


@pytest.mark.parametrize("rows, h, p, t, want", [
    (256 * 16 * 4, 4, 16, 256, 1),     # stage 1: 1,024 tiles
    (256 * 16, 16, 1, 256, 2),         # stage 3: 256 tiles
    (256 * 32, 32, 1, 64, 9),          # stage 4: 32 tiles
    (2 * 4, 4, 1, 64, 2)])             # never more groups than images
def test_dbias_kernel_splits_images_to_fill_the_card(rows, h, p, t, want):
    assert ss.dbias_groups(rows, h, p, t) == want


def test_bias_index_reads_window_then_head():
    # rows are (image, window, head) with the head fastest
    assert ss.bias_index(12, 2, 3).tolist() == [0, 1, 2, 3, 4, 5,
                                                0, 1, 2, 3, 4, 5]
    assert ss.bias_index(4, 2, 1).tolist() == [0, 1, 0, 1]


def test_biased_helper_on_the_cpu_is_the_layers_plain_path():
    """A SwinV2 block with the ``attention_bias`` helper claimed for the
    CPU (the Function over the plain functions, as the card runs the
    kernels) against its own materialised path: the same output and
    gradients within float32 rounding."""
    layer = SwinV2Block(n_in=16, num_heads=2, window_size=4, shift_size=2,
                        cpb_hidden=16)
    params = layer.init_params(torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 8, 16, generator=torch.Generator().manual_seed(1))

    def run():
        ps = {k: p.clone().requires_grad_(True) for k, p in params.items()}
        y, _ = layer.forward(ps, {}, x)
        return y, torch.autograd.grad(y.square().sum(), list(ps.values()))

    y0, g0 = run()
    snap = helpers.snapshot_helper("attention_bias")
    helpers.register_helper("attention_bias", ss.biased_attention, ("cpu",),
                            _scoped=True)
    try:
        y1, g1 = run()
    finally:
        helpers.restore_helper("attention_bias", snap)
    assert (y1 - y0).abs().max() <= 1e-5
    for a, b in zip(g1, g0):
        assert _rel(a, b, floor=1e-6) <= 1e-4


def test_biased_wrappers_take_the_plain_path_on_the_cpu():
    q3 = torch.randn(4, 16, 8)
    bias = torch.randn(1, 2, 16, 16)
    before = ss.short_attention_bias_fwd.launches
    o, lse = ss.short_attention_bias_fwd(q3, q3, q3, bias, 2, 1.0)
    want = ss.attention_fwd_plain(q3, q3, q3, None, 2, False, 1.0, bias)
    assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
    assert ss.short_attention_bias_fwd.launches == before
    with pytest.raises(ValueError, match="T <= 512"):
        x = torch.zeros(1, 600, 2, 8)
        ss.biased_attention(x, x, x, torch.zeros(1, 2, 600, 600))


# ------------------------------------------------------- the constants
def test_coordinate_table_by_hand():
    table, _, _ = swin.window_constants(2, 0, 2, 2, -100.0, "cpu")
    a = math.log2(9.0) / 3.0          # |Δ| = 1 at M = 2: log2(1 + 8) / 3
    want = [[-a, -a], [-a, 0], [-a, a], [0, -a], [0, 0], [0, a],
            [a, -a], [a, 0], [a, a]]
    assert torch.allclose(table, torch.tensor(want), atol=1e-6)


def test_relative_index_by_hand():
    _, index, _ = swin.window_constants(2, 0, 2, 2, -100.0, "cpu")
    # tokens (0,0), (0,1), (1,0), (1,1); index (Δr + 1)·3 + (Δc + 1)
    assert index.tolist() == [[4, 3, 1, 0], [5, 4, 2, 1],
                              [7, 6, 4, 3], [8, 7, 5, 4]]


def test_shift_mask_by_hand():
    # 4 x 4 at M 2, shift 1: regions per axis [0, 0, 1, 2]
    _, _, mask = swin.window_constants(2, 1, 4, 4, -100.0, "cpu")
    assert mask.shape == (4, 4, 4)
    assert (mask[0] == 0).all()                 # rows 0-1, cols 0-1
    # rows 0-1, cols 2-3: tokens' regions [1, 2, 1, 2]
    same = torch.tensor([[1, 0, 1, 0], [0, 1, 0, 1], [1, 0, 1, 0],
                         [0, 1, 0, 1]], dtype=torch.bool)
    assert torch.equal(mask[1] == 0, same)
    # rows 2-3, cols 0-1: tokens' regions [1, 1, 2, 2]
    rows = torch.tensor([[1, 1, 0, 0], [1, 1, 0, 0], [0, 0, 1, 1],
                         [0, 0, 1, 1]], dtype=torch.bool)
    assert torch.equal(mask[2] == 0, rows)
    # rows 2-3, cols 2-3: four regions, each token alone
    assert torch.equal(mask[3] == 0, torch.eye(4, dtype=torch.bool))
    assert set(mask.unique().tolist()) == {-100.0, 0.0}


@pytest.mark.parametrize("m, s, res", [(16, 8, 64), (16, 8, 32), (8, 0, 8),
                                       (4, 2, 8)])
def test_constants_equal_the_references_construction(m, s, res):
    table, index, mask = swin.window_constants(m, s, res, res, -100.0,
                                               "cpu")
    assert torch.allclose(table, ref.relative_coords(m, CPU), atol=1e-6)
    assert torch.equal(index, ref.relative_index(m, CPU))
    if s:
        assert torch.equal(mask, ref.shift_mask(m, s, res, res, -100.0, CPU))
    else:
        assert mask is None


def test_window_clips_to_the_resolution():
    assert swin.window_of(64, 64, 16, 8) == (16, 8)
    assert swin.window_of(16, 16, 16, 8) == (16, 0)
    assert swin.window_of(8, 8, 16, 8) == (8, 0)


def test_partition_and_reverse_are_inverse():
    x = torch.arange(2 * 8 * 8 * 3, dtype=torch.float32).view(2, 8, 8, 3)
    xw = swin.partition(x, 4)
    assert xw.shape == (8, 16, 3)
    assert torch.equal(xw[1, 0], x[0, 0, 4])   # image 0, window (0, 1)
    assert torch.equal(swin.reverse(xw, 4, 2, 8, 8), x)


# ------------------------------------------------------ spans and serde
def test_swin_block_opens_its_spans_under_a_profiler():
    layer = SwinV2Block(n_in=16, num_heads=2, window_size=4, shift_size=2,
                        cpb_hidden=16)
    params = layer.init_params(torch.Generator().manual_seed(0))
    merge = PatchMerging(n_in=16, n_out=32)
    mparams = merge.init_params(torch.Generator().manual_seed(1))
    x = torch.randn(1, 8, 8, 16)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        y, _ = layer.forward(params, {}, x)
        merge.forward(mparams, {}, y)
    names = {e.name for e in prof.events()}
    assert {"dl4j.swin.shuffle", "dl4j.swin.bias",
            "dl4j.swin.attention"} <= names


@pytest.mark.parametrize("conf", [
    SwinV2Block(n_in=128, num_heads=4, window_size=16, shift_size=8,
                cpb_hidden=512, eps=1e-5),
    PatchMerging(n_in=128, n_out=256, eps=1e-5),
    ChannelLayerNorm(n_in=1024, eps=1e-5)], ids=lambda c: type(c).__name__)
def test_layer_conf_serde_round_trip(conf):
    back = from_jsonable(json.loads(json.dumps(to_jsonable(conf))))
    assert type(back) is type(conf) and back == conf


def test_swinv2_graph_json_round_trip_and_types():
    conf = swinv2_conf(10, 32, 4, 16, (2, 2), (1, 2), 4, cpb_hidden=16)
    back = ComputationGraphConfiguration.from_json(conf.to_json())
    assert back.to_json() == conf.to_json()
    blocks = [v.layer for n, v in conf.vertices.items()
              if n.startswith("s") and "_" not in n]
    assert [b.shift_size for b in blocks] == [0, 2, 0, 2]
    assert [b.n_in for b in blocks] == [16, 16, 32, 32]
    assert conf.vertices["s0_merge"].layer.n_out == 32
    assert conf.vertices["fc"].layer.n_in == 32
