"""PyTorch port: mesh-sharded serving (``parallel/mesh.py``,
``parallel/spec_layout.py``, the decoder's and the engine's ``mesh=``)
against the JAX package, mirroring ``tests/test_generation_mesh.py``.

Every shard of the port's meshes lives on the CPU (``devices=["cpu"] *
n``); the JAX decoder runs on conftest's 8 virtual CPU devices. One tiny
LM is trained once by the JAX package and its weights carried over. On
meshes (1,1), (2,1), (1,2), (2,2) and (4,1) at K in {1, 4, 8}: greedy
tokens identical to the JAX decoder on the same mesh and to the port's
unsharded decoder, fixed-seed sampled tokens identical across the port's
meshes, f32 prefill logits within 1e-5 of JAX's; the validation
messages; padding, the FSDP layout and caches born sharded; the paged,
speculative, sentinel and scheduling routes against the unsharded engine
and JAX's tokens; the paged pool's data copies bit-identical; one
readback a block gathering data x tp shards; the supervisor restart and
the facades."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import (SlotGenerationEngine as JaxEngine,
                                       TransformerDecoder as JaxDecoder,
                                       lm_batch,
                                       transformer_lm_conf as jax_lm_conf)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.ops.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.parallel import spec_layout as jlayout
from deeplearning4j_tpu_torch.models import (SlotGenerationEngine,
                                             TransformerDecoder,
                                             transformer_lm_conf)
from deeplearning4j_tpu_torch.observability import IntegrityConfig
from deeplearning4j_tpu_torch.observability.devstats import kv_cache_stats
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.ops.transfer import fetch_counts, fetch_shards
from deeplearning4j_tpu_torch.parallel import (EngineSupervisor,
                                               FaultInjector, P,
                                               ParallelInference,
                                               ShardedTensor, SpecLayout,
                                               decoder_param_specs,
                                               generation_mesh, make_mesh,
                                               mesh_tag, parse_mesh_shape,
                                               shard_params,
                                               validate_decode_mesh,
                                               validate_param_specs)
from deeplearning4j_tpu_torch.parallel.mesh import local_slice
from deeplearning4j_tpu_torch.utils import graph_from_numpy

VOCAB = 12
KW = dict(vocab_size=VOCAB, d_model=32, num_heads=2, num_layers=2,
          max_length=32, seed=5)
MESH_SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1)]
BLOCK_SIZES = [1, 4, 8]
IDS = [f"{d}x{t}" for d, t in MESH_SHAPES]


def _cpu_mesh(data, tp):
    return generation_mesh(data, tp, devices=["cpu"] * (data * tp))


@pytest.fixture(scope="module")
def nets():
    """The JAX tiny LM trained once (test_generation_mesh.py's recipe)
    and the port's net on the CPU with its weights."""
    rng = np.random.default_rng(12345)
    jnet = JaxGraph(jax_lm_conf(**KW, learning_rate=1e-2)).init()
    starts = rng.integers(0, VOCAB, (16, 1))
    seq = (starts + np.arange(17)[None, :]) % VOCAB
    x, y = lm_batch(seq, VOCAB)
    ds = JaxDataSet(x, y)
    for _ in range(150):
        jnet.fit_batch(ds)
    net = graph_from_numpy(transformer_lm_conf(**KW, learning_rate=1e-2),
                           {v: {k: np.asarray(a) for k, a in p.items()}
                            for v, p in jnet.params.items()}, device="cpu")
    return jnet, net


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(777)
    return [rng.integers(0, VOCAB, n) for n in (3, 7, 5, 2)]


def _same(a_list, b_list, msg=""):
    assert len(a_list) == len(b_list), msg
    for a, b in zip(a_list, b_list):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=msg)


# ------------------------------------------------------------ validation
class TestMeshValidation:
    def test_shape_exceeding_devices_names_the_fix(self):
        with pytest.raises(ValueError) as e:
            make_mesh(axis_names=("data", "tp"), shape=(8, 2),
                      devices=["cpu"] * 8)
        msg = str(e.value)
        assert "needs 16 devices" in msg and "8 listed" in msg
        assert 'devices=[torch.device("cuda:0")] * N' in msg

    def test_default_devices_are_the_cards(self):
        with pytest.raises(ValueError) as e:
            make_mesh(n_devices=torch.cuda.device_count() + 1)
        assert "torch.cuda.device_count()" in str(e.value)

    def test_n_devices_over_budget(self):
        with pytest.raises(ValueError, match="only 8 device"):
            make_mesh(n_devices=16, devices=["cpu"] * 8)

    def test_multi_axis_without_shape(self):
        with pytest.raises(ValueError, match="pass shape"):
            make_mesh(axis_names=("data", "tp"), devices=["cpu"] * 2)

    def test_shape_axis_arity_mismatch(self):
        with pytest.raises(ValueError, match="one size per named axis"):
            make_mesh(axis_names=("data", "tp"), shape=(4,),
                      devices=["cpu"] * 4)

    def test_zero_axis_size(self):
        with pytest.raises(ValueError, match=">= 1"):
            make_mesh(axis_names=("data", "tp"), shape=(0, 2),
                      devices=["cpu"] * 4)

    @pytest.mark.parametrize("shape,kw", [
        ((1, 4), dict(num_heads=2)), ((4, 1), dict(num_slots=3)),
        ((2, 2), dict(num_heads=3, num_slots=5))])
    def test_decode_mesh_messages_match_jax(self, shape, kw):
        with pytest.raises(ValueError) as want:
            jmesh.validate_decode_mesh(jmesh.generation_mesh(*shape), **kw)
        with pytest.raises(ValueError) as got:
            validate_decode_mesh(_cpu_mesh(*shape), **kw)
        assert str(got.value) == str(want.value)

    def test_decoder_rejects_indivisible_heads(self, nets):
        with pytest.raises(ValueError, match="num_heads 2"):
            TransformerDecoder(nets[1], mesh=_cpu_mesh(1, 4))

    def test_engine_rejects_indivisible_slots(self, nets):
        with pytest.raises(ValueError, match="num_slots 3"):
            SlotGenerationEngine(nets[1], num_slots=3,
                                 mesh=_cpu_mesh(2, 1))

    def test_decoder_rejects_a_non_mesh(self, nets):
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            TransformerDecoder(nets[1], mesh=object())

    @pytest.mark.parametrize("text", ["2x1", "1x2", "4", " 2X2 "])
    def test_parse_mesh_shape_matches_jax(self, text):
        assert parse_mesh_shape(text) == jmesh.parse_mesh_shape(text)

    @pytest.mark.parametrize("text,match", [("2x2x2", "DATAxTP"),
                                            ("axb", "integers"),
                                            ("0x1", ">= 1")])
    def test_parse_mesh_shape_errors_match_jax(self, text, match):
        with pytest.raises(ValueError, match=match) as got:
            parse_mesh_shape(text)
        with pytest.raises(ValueError) as want:
            jmesh.parse_mesh_shape(text)
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("shape", [(2, 1), (1, 2), (4, 2)])
    def test_mesh_tag_matches_jax(self, shape):
        assert mesh_tag(None) == jmesh.mesh_tag(None) == ""
        assert mesh_tag(_cpu_mesh(*shape)) == \
            jmesh.mesh_tag(jmesh.generation_mesh(*shape))


# ------------------------------------------------------------ SpecLayout
class TestSpecLayout:
    @pytest.mark.parametrize("fsdp", [None, "data"])
    def test_role_table_matches_jax(self, nets, fsdp):
        jnet, net = nets
        want = jlayout.decoder_param_specs(
            JaxDecoder(jnet), jlayout.SpecLayout(fsdp_axis=fsdp))
        got = decoder_param_specs(TransformerDecoder(net),
                                  SpecLayout(fsdp_axis=fsdp))
        assert {v: {k: tuple(s) for k, s in t.items()}
                for v, t in got.items()} == \
            {v: {k: tuple(s) for k, s in t.items()}
             for v, t in want.items()}
        validate_param_specs(_cpu_mesh(2, 2), got, net.params)

    def test_overranked_spec_names_the_leaf(self, nets):
        dec = TransformerDecoder(nets[1])
        specs = decoder_param_specs(dec)
        attn = dec.attn_names[0]
        specs[attn] = dict(specs[attn], bo=P("data", "tp"))
        with pytest.raises(ValueError) as e:
            validate_param_specs(_cpu_mesh(2, 2), specs, nets[1].params)
        assert f"{attn}.bo" in str(e.value) and "rank" in str(e.value)

    def test_unknown_axis_names_the_mesh(self, nets):
        specs = decoder_param_specs(TransformerDecoder(nets[1]),
                                    SpecLayout(tp_axis="model"))
        with pytest.raises(ValueError, match="absent from the mesh"):
            validate_param_specs(_cpu_mesh(2, 2), specs, nets[1].params)

    def test_indivisible_dim_is_reported(self, nets):
        specs = decoder_param_specs(TransformerDecoder(nets[1]))
        emb = [n for n in specs if "W" in specs[n] and "P" in specs[n]][0]
        specs[emb] = {"W": P("tp", None)}          # vocab 12 over tp 8
        mesh = make_mesh(axis_names=("data", "tp"), shape=(1, 8),
                         devices=["cpu"] * 8)
        with pytest.raises(ValueError, match="not divisible"):
            validate_param_specs(mesh, specs, nets[1].params)

    def test_spec_for_missing_param(self, nets):
        dec = TransformerDecoder(nets[1])
        specs = decoder_param_specs(dec)
        attn = dec.attn_names[0]
        specs[attn] = dict(specs[attn], Wz=P(None, "tp"))
        with pytest.raises(ValueError, match="does not have"):
            validate_param_specs(_cpu_mesh(1, 1), specs, nets[1].params)

    def test_shard_params_places_each_coordinates_part(self, nets):
        net = nets[1]
        mesh = _cpu_mesh(2, 2)
        layout = SpecLayout(fsdp_axis="data")
        specs = decoder_param_specs(TransformerDecoder(net), layout)
        parts = shard_params(mesh, specs, net.params)
        assert sorted(parts) == [(0, 0), (0, 1), (1, 0), (1, 1)]
        w1 = net.params["ffn0"]["W1"]                     # [32, 128]
        for (d, t), tree in parts.items():
            got = tree["ffn0"]["W1"]
            assert tuple(got.shape) == (16, 64)
            torch.testing.assert_close(
                got, w1[d * 16:(d + 1) * 16, t * 64:(t + 1) * 64],
                rtol=0, atol=0)
            assert torch.equal(tree["lnf"]["gamma"],
                               net.params["lnf"]["gamma"])

    @pytest.mark.parametrize("spec,part", [
        (P("data", "tp"), lambda t, d, k: t[2 * d:2 * d + 2, 2 * k:2 * k + 2]),
        (P(None, "tp"), lambda t, d, k: t[:, 2 * k:2 * k + 2]),
        (P(("data", "tp")), lambda t, d, k: t[2 * d + k:2 * d + k + 1])])
    def test_local_slices_and_sharded_zeros(self, spec, part):
        mesh = _cpu_mesh(2, 2)
        t = torch.arange(4 * 4 * 3, dtype=torch.float32).reshape(4, 4, 3)
        st = ShardedTensor.zeros(mesh, spec, t.shape, t.dtype)
        assert st.num_shards == 4 and tuple(st.shape) == (4, 4, 3)
        for d, k in mesh.coords():
            want = part(t, d, k)
            assert torch.equal(local_slice(mesh, spec, (d, k), t), want)
            assert st.local((d, k)).shape == want.shape
        assert st.addressable_bytes == sum(
            part(t, d, k).numel() * 4 for d, k in mesh.coords())


# ------------------------------------------------------- decoder parity
@pytest.fixture(scope="module")
def reference(nets, prompts):
    """The port's unsharded streams per K, greedy and sampled; the
    unsharded decoder is K-consistent."""
    dec = TransformerDecoder(nets[1])
    greedy = {k: dec.generate(prompts, 10, block_size=k)
              for k in BLOCK_SIZES}
    sampled = {k: dec.generate(prompts, 10, temperature=1.0, seed=11,
                               block_size=k) for k in BLOCK_SIZES}
    for k in BLOCK_SIZES[1:]:
        _same(greedy[1], greedy[k])
        _same(sampled[1], sampled[k])
    return greedy, sampled


@pytest.fixture(scope="module")
def jax_greedy(nets, prompts):
    """JAX's greedy stream on each mesh (K-invariant: one K a mesh)."""
    return {shape: JaxDecoder(nets[0], mesh=jmesh.generation_mesh(*shape))
            .generate(prompts, 10, temperature=0.0, block_size=4)
            for shape in MESH_SHAPES}


class TestMeshParity:
    @pytest.mark.parametrize("k", BLOCK_SIZES)
    @pytest.mark.parametrize("shape", MESH_SHAPES, ids=IDS)
    def test_tokens_match_jax_and_unsharded(self, nets, prompts, reference,
                                            jax_greedy, shape, k):
        greedy, sampled = reference
        dec = TransformerDecoder(nets[1], mesh=_cpu_mesh(*shape))
        before = fetch_counts("generate.decode")["generate.decode"]
        got = dec.generate(prompts, 10, block_size=k)
        blocks = fetch_counts("generate.decode")["generate.decode"] - before
        tag = f"mesh={shape} K={k}"
        _same(got, jax_greedy[shape], "vs JAX " + tag)
        _same(got, greedy[k], "vs unsharded " + tag)
        _same(dec.generate(prompts, 10, temperature=1.0, seed=11,
                           block_size=k), sampled[k], "sampled " + tag)
        # one readback a block (10 tokens: the prefill's, then 9 in
        # ceil(9 / K) blocks), gathering every shard of the mesh
        assert blocks == -(-9 // k)
        assert fetch_shards("generate.decode")["generate.decode"] == \
            shape[0] * shape[1]

    @pytest.mark.parametrize("shape", MESH_SHAPES, ids=IDS)
    def test_prefill_logits_match_jax(self, nets, prompts, shape):
        jnet, net = nets
        lengths = np.asarray([len(p) for p in prompts], np.int64)
        tokens = np.zeros((len(prompts), 8), np.int64)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
        jd = JaxDecoder(jnet, mesh=jmesh.generation_mesh(*shape))
        _, want, _ = jd.prefill(jd.init_cache(len(prompts)),
                                tokens.astype(np.int32),
                                lengths.astype(np.int32))
        dec = TransformerDecoder(net, mesh=_cpu_mesh(*shape))
        _, got, _ = dec.prefill(dec.init_cache(len(prompts)), tokens,
                                lengths)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        _, rec = dec.recompute_logits(tokens, lengths)
        np.testing.assert_allclose(rec.numpy(), got.numpy(), rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("temps", [0.0, [0.0, 0.7, 1.3]],
                             ids=["greedy", "per-row-temps"])
    def test_non_divisible_batch_pads_and_matches(self, nets, prompts,
                                                  temps):
        """3 prompts on data 2: rows pad to the axis, outputs equal the
        unsharded run's."""
        want = TransformerDecoder(nets[1]).generate(
            prompts[:3], 8, temperature=temps, seed=11, block_size=4)
        got = TransformerDecoder(nets[1], mesh=_cpu_mesh(2, 1)).generate(
            prompts[:3], 8, temperature=temps, seed=11, block_size=4)
        assert len(got) == 3
        _same(got, want)

    def test_fsdp_layout_parity(self, nets, prompts, reference):
        dec = TransformerDecoder(nets[1], mesh=_cpu_mesh(2, 2),
                                 spec_layout=SpecLayout(fsdp_axis="data"))
        _same(dec.generate(prompts, 10, block_size=4), reference[0][4])

    def test_cache_is_born_sharded(self, nets):
        dec = TransformerDecoder(nets[1], mesh=_cpu_mesh(2, 2))
        for name, c in dec.init_cache(4).items():
            k = c["k"]
            assert isinstance(k, ShardedTensor) and k.num_shards == 4
            assert tuple(k.spec)[:2] == ("data", "tp")
            assert tuple(k.shape) == (4, 2, 32, 16)
            assert tuple(k.local((1, 1)).shape) == (2, 1, 32, 16)
        with pytest.raises(ValueError, match="not divisible"):
            dec.init_cache(3)
        pool = dec.init_paged_pool(9, 8)[dec.attn_names[0]]["v"]
        assert tuple(pool.local((1, 0)).shape) == (9, 1, 8, 16)
        assert pool.addressable_bytes == 2 * pool.numel() * 4

    def test_weight_swap_rebuilds_the_shards(self, nets, prompts):
        """The shards come from the cast cache keyed on net.params: a new
        params tree is placed again, once."""
        net = graph_from_numpy(transformer_lm_conf(**KW),
                               {v: {k: a.numpy() for k, a in p.items()}
                                for v, p in nets[1].params.items()},
                               device="cpu")
        dec = TransformerDecoder(net, mesh=_cpu_mesh(1, 2))
        before = dec.generate(prompts, 6, block_size=4)
        assert dec.param_casts == 1
        net.params = {v: {k: a * 0.5 if a.ndim == 2 else a
                          for k, a in p.items()}
                      for v, p in net.params.items()}
        after = dec.generate(prompts, 6, block_size=4)
        assert dec.param_casts == 2
        _same(after, TransformerDecoder(net).generate(prompts, 6,
                                                      block_size=4))
        assert any(not np.array_equal(a, b) for a, b in zip(before, after))


# -------------------------------------------------------------- engines
def _stream(seed=31, n=8):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, VOCAB, int(rng.integers(2, 9)))
               for _ in range(n)]
    gens = [int(rng.integers(3, 9)) for _ in range(n)]
    return prompts, gens


def _run(engine, prompts, gens, temps=None):
    temps = temps or [0.0] * len(prompts)
    reqs = [engine.submit(p, g, temperature=t)
            for p, g, t in zip(prompts, gens, temps)]
    engine.run_until_drained()
    return [r.result(5) for r in reqs]


ROUTES = {
    "slab": dict(block_size=4),
    "paged": dict(block_size=4, paged=True, page_size=8),
    "speculative": dict(speculative=True, spec_k=3, spec_threshold=0.0),
    "paged-speculative": dict(paged=True, page_size=8, speculative=True,
                              spec_k=3, spec_threshold=0.0),
    "sentinel": dict(block_size=4, paged=True, page_size=8),
    "scheduling": dict(block_size=4, scheduling="edf", prefill_chunk=4,
                       adaptive_block=True),
}


class TestShardedEngine:
    @pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
    @pytest.mark.parametrize("route", list(ROUTES))
    def test_route_matches_unsharded_and_jax(self, nets, route, shape):
        jnet, net = nets
        kw = dict(ROUTES[route])
        port_kw, jax_kw = dict(kw), dict(kw)
        if route == "sentinel":
            port_kw["integrity"] = IntegrityConfig()
            from deeplearning4j_tpu.observability import integrity as ji
            jax_kw["integrity"] = ji.IntegrityConfig()
        prompts, gens = _stream()
        want = _run(JaxEngine(jnet, num_slots=4, **jax_kw), prompts, gens)
        plain = _run(SlotGenerationEngine(net, num_slots=4, **port_kw),
                     prompts, gens)
        mesh = _cpu_mesh(*shape)
        eng = SlotGenerationEngine(net, num_slots=4, mesh=mesh, **port_kw)
        before = fetch_counts("engine.decode")["engine.decode"]
        got = _run(eng, prompts, gens)
        fetched = fetch_counts("engine.decode")["engine.decode"] - before
        _same(got, plain, f"{route} {shape} vs unsharded")
        _same(got, want, f"{route} {shape} vs JAX")
        st = eng.stats()
        assert st["mesh_shape"] == mesh_tag(mesh)
        assert fetched <= st["decode_blocks"] + st["spec_blocks"]
        assert fetch_shards("engine.decode")["engine.decode"] == \
            shape[0] * shape[1]
        if "speculative" in route:
            assert st["spec_blocks"] > 0
        if eng._pager is not None:
            assert eng._pager.audit(eng._slot_pages) == []
        # sampled lanes: identical to the unsharded engine's
        temps = [0.0, 0.9] * 4
        _same(_run(SlotGenerationEngine(net, num_slots=4, mesh=mesh,
                                        seed=3, **port_kw),
                   prompts, gens, temps),
              _run(SlotGenerationEngine(net, num_slots=4, seed=3,
                                        **port_kw), prompts, gens, temps))

    @pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
    def test_paged_pool_copies_stay_identical(self, nets, shape):
        """A mixed stream with shared prefixes, preemption under a small
        pool and chunked tails: every data group's copy of the pool ends
        bit-identical."""
        net = nets[1]
        rng = np.random.default_rng(5)
        head = rng.integers(0, VOCAB, 9)
        prompts = [np.concatenate([head, rng.integers(0, VOCAB, n)])
                   for n in (1, 3, 2, 5, 4, 6, 2, 3)]
        gens = [6, 9, 4, 7, 5, 8, 3, 6]
        kw = dict(num_slots=4, block_size=4, paged=True, page_size=4,
                  num_pages=18, prefill_chunk=6)
        want = _run(SlotGenerationEngine(net, **kw), prompts, gens)
        eng = SlotGenerationEngine(net, mesh=_cpu_mesh(*shape), **kw)
        _same(_run(eng, prompts, gens), want)
        st = eng.stats()
        assert st["prefix_cache_hits"] > 0
        for name, kv in eng._caches.items():
            for kk, leaf in kv.items():
                for t in range(shape[1]):
                    first = leaf.local((0, t))
                    for d in range(1, shape[0]):
                        assert torch.equal(leaf.local((d, t)), first), \
                            (name, kk, d, t)
        assert eng._pager.audit(eng._slot_pages) == []

    def test_kv_export_import_keeps_the_frame_format(self, nets):
        net = nets[1]
        prompts, gens = _stream(9, 4)
        kw = dict(num_slots=4, block_size=4, paged=True, page_size=8)
        plain = SlotGenerationEngine(net, **kw)
        eng = SlotGenerationEngine(net, mesh=_cpu_mesh(2, 2), **kw)
        for e in (plain, eng):
            for p in prompts:
                e.submit(p, 30)
            e._admit()
        pids = plain._slot_pages[0] + plain._slot_pages[1]
        assert pids and pids == eng._slot_pages[0] + eng._slot_pages[1]
        want = plain._export_pages(pids)
        got = eng._export_pages(pids)
        for n in want:
            for kk in ("k", "v"):
                # the tp shards project their own heads' columns
                np.testing.assert_allclose(got[n][kk], want[n][kk],
                                           rtol=1e-5, atol=1e-6)
        zeros = {n: {kk: np.zeros_like(a) for kk, a in kv.items()}
                 for n, kv in got.items()}
        eng._import_pages(pids, zeros)
        for kv in eng._caches.values():
            for leaf in kv.values():
                for c in leaf.mesh.coords():
                    assert not leaf.local(c)[pids].any()

    def test_sentinel_fault_routes_to_the_owner_group(self, nets):
        """A NaN poisoned into one lane's slab cell (its owner group's
        rows) fails exactly that request, as on one device; the verdict
        rides the block's single readback."""
        net = nets[1]
        prompts, gens = _stream(0, 6)
        gens = [5] * 6
        outs = []
        for mesh in (None, _cpu_mesh(2, 2)):
            inj = FaultInjector()
            inj.corrupt("device.corrupt_logits", mode="nan", at=1)
            eng = SlotGenerationEngine(net, num_slots=2, block_size=4,
                                       mesh=mesh, fault_injector=inj,
                                       integrity=IntegrityConfig())
            reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
            eng.run_until_drained()
            outs.append([(r.state, list(r.generated)) for r in reqs])
        assert outs[0] == outs[1]
        assert sum(s == "FAILED" for s, _ in outs[1]) == 1

    def test_mixed_stream_programs_and_devstats(self, nets):
        net = nets[1]
        prompts, gens = _stream(31, 5)
        mesh = _cpu_mesh(2, 2)
        dec = TransformerDecoder(net, mesh=mesh)
        eng = SlotGenerationEngine(net, num_slots=2, block_size=4,
                                   decoder=dec)
        before = fetch_counts()
        got = _run(eng, prompts, gens)
        after = fetch_counts()
        assert fetch_shards("engine.prefill")["engine.prefill"] == 4
        _same(got, _run(SlotGenerationEngine(net, num_slots=2,
                                             block_size=4), prompts, gens))
        st = eng.stats()
        assert after["engine.decode"] - before.get("engine.decode", 0) <= \
            st["decode_blocks"]
        assert after["engine.prefill"] - before.get("engine.prefill", 0) \
            == st["prefill_batches"]
        assert dec._cost_seam and all(n.endswith("__m2x2")
                                      for n in dec._cost_seam)
        kv = kv_cache_stats(eng)
        assert kv["mesh"] == "2x2" and kv["shards"] == 4
        assert kv["addressable_bytes"] == kv["bytes"]       # slab: no copy
        # a second engine over the same sharded decoder casts nothing
        casts = dec.param_casts
        _run(SlotGenerationEngine(net, num_slots=2, block_size=4,
                                  decoder=dec), prompts, gens)
        assert dec.param_casts == casts

    def test_supervisor_restart_on_sharded_engine(self, nets):
        net = nets[1]
        prompts, _ = _stream(32, 3)
        mesh = _cpu_mesh(2, 1)
        dec = TransformerDecoder(net, mesh=mesh)
        wants = TransformerDecoder(net).generate(prompts, 6, block_size=4)
        inj = FaultInjector()
        inj.raise_once("engine.step", RuntimeError("injected crash"), at=2)
        eng = SlotGenerationEngine(net, num_slots=2, block_size=4,
                                   decoder=dec, fault_injector=inj)
        sup = EngineSupervisor(eng, timeout=10.0, interval=0.1,
                               max_restarts=2)
        dec._device_params()                 # the one cast and placement
        casts = dec.param_casts
        sup.start()
        try:
            outs = [r.result(60) for r in [sup.submit(p, 6)
                                           for p in prompts]]
            _same(outs, wants)
            assert sup.restarts == 1
            assert sup.stats()["mesh_shape"] == "2x1"
            assert sup._engine.mesh is mesh
            assert dec.param_casts == casts
        finally:
            sup.stop()

    def test_mesh_threads_through_facades(self, nets):
        from deeplearning4j_tpu_torch.streaming.pubsub import (
            MessageBroker, NDArrayPublisher, NDArraySubscriber)
        from deeplearning4j_tpu_torch.streaming.serving import \
            GenerationServingRoute
        net = nets[1]
        rng = np.random.default_rng(33)
        mesh = _cpu_mesh(2, 1)
        ref = TransformerDecoder(net)
        pi = ParallelInference(net, generation_slots=2,
                               generation_block_size=4,
                               generation_mesh=mesh,
                               generation_registry=MetricsRegistry())
        try:
            ps = [rng.integers(0, VOCAB, n) for n in (3, 5)]
            for p in ps:
                _same([pi.generate(p, 6, timeout=60)],
                      ref.generate([p], 6, block_size=4))
            assert pi._gen_engine.mesh is mesh
        finally:
            pi.shutdown()
        broker = MessageBroker()
        out_sub = NDArraySubscriber(broker, "dl4j-gen-output")
        route = GenerationServingRoute(net, broker, max_new_tokens=5,
                                       num_slots=2, block_size=4,
                                       mesh=mesh,
                                       registry=MetricsRegistry()).start()
        try:
            assert route.engine.mesh is mesh
            pub = NDArrayPublisher(broker, "dl4j-gen-input")
            ps = [rng.integers(0, VOCAB, n) for n in (4, 2)]
            for p in ps:
                pub.publish(np.asarray(p, np.int32))
            outs = [out_sub.poll(timeout=60) for _ in ps]
            _same([np.asarray(o, np.int64) for o in outs],
                  ref.generate(ps, 5, block_size=4))
        finally:
            route.stop()

    def test_shared_decoder_mesh_conflict_rejected(self, nets):
        dec = TransformerDecoder(nets[1], mesh=_cpu_mesh(2, 1))
        with pytest.raises(ValueError, match="different mesh"):
            SlotGenerationEngine(nets[1], num_slots=2, decoder=dec,
                                 mesh=_cpu_mesh(1, 2))

    def test_route_prebuilt_engine_mesh_conflict_rejected(self, nets):
        from deeplearning4j_tpu_torch.streaming.pubsub import MessageBroker
        from deeplearning4j_tpu_torch.streaming.serving import \
            GenerationServingRoute
        eng = SlotGenerationEngine(nets[1], num_slots=2)
        with pytest.raises(ValueError, match="different mesh"):
            GenerationServingRoute(nets[1], MessageBroker(), engine=eng,
                                   mesh=_cpu_mesh(2, 1))
        mesh = _cpu_mesh(2, 1)
        eng2 = SlotGenerationEngine(nets[1], num_slots=2, mesh=mesh)
        route = GenerationServingRoute(nets[1], MessageBroker(),
                                       engine=eng2, mesh=mesh)
        assert route.engine.mesh is mesh

    def test_topology_telemetry(self, nets):
        reg = MetricsRegistry()
        eng = SlotGenerationEngine(nets[1], num_slots=4,
                                   mesh=_cpu_mesh(4, 2), registry=reg)
        assert eng.stats()["mesh_shape"] == "4x2"
        fam = reg.gauge("generation_mesh_axis_size",
                        "serving-mesh axis size (data/tp)",
                        ("engine", "axis"))
        assert fam.labels(eng.engine_id, "data").value == 4
        assert fam.labels(eng.engine_id, "tp").value == 2
        eng2 = SlotGenerationEngine(nets[1], num_slots=2,
                                    registry=MetricsRegistry())
        assert eng2.stats()["mesh_shape"] is None


# ---------------------------------------------------- ParallelInference
@pytest.mark.parametrize("n", [2, 4])
def test_parallel_inference_data_parallel_forward_matches_jax(nets, n):
    from deeplearning4j_tpu.parallel.inference import \
        ParallelInference as JaxParallelInference
    jnet, net = nets
    x = np.random.default_rng(2).integers(0, VOCAB, (5, 7)).astype(
        np.float32)
    want = JaxParallelInference(jnet).output(x)
    pi = ParallelInference(net, mesh=make_mesh(n, devices=["cpu"] * n))
    try:
        got = pi.output(x)
    finally:
        pi.shutdown()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, ParallelInference(net).output(x))
