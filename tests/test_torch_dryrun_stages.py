"""The port's dry-run (``repro_torch.launch.dryrun_lib``) over two-stage
plans: the local/global family's (``gemma3-4b``: 5 x [5 window + 1
global], then 4 window layers) and the MoE family's (``deepseek-moe-16b``:
1 dense, then 27 MoE layers; ``deepseek-v3-671b``: 3 dense MLA layers,
then 58 MoE MLA layers, and the MTP module), held to ``unroll=True`` and
to the reference's compiled smoke cells (a 1 x 1 mesh with Auto axes, as
in tests/test_torch_dryrun.py), and their sharding specs held to the
reference's; the VLM family's (``llama-3.2-vision-90b``: 20 x [4
self-attention + 1 cross-attention layer], the image embeddings an
argument of every cell) the same way."""
import dataclasses
from functools import partial

import jax
import pytest
from jax.sharding import AxisType

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsharding
from repro.launch import dryrun_lib as jdry
from repro.launch import specs as jspecs
from repro.models import model as jmodel
from repro_torch.common import hlo
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun_lib, specs
from repro_torch.models import model
from repro_torch.models.layers import ModelContext, ShapesOnly

CELLS = ("prefill_32k", "decode_32k", "train_4k", "long_500k")
# train and prefill at shorter shapes than the matrix's, as in
# tests/test_torch_dryrun.py
DEPTH_SHAPES = [ShapeConfig("train_512", "train", 512, 8),
                SHAPES["decode_32k"],
                ShapeConfig("prefill_4k", "prefill", 4096, 32)]


def _gemma_cut(blocks, tail):
    """``gemma3-4b-smoke`` at the full config's ratio (5 window layers and
    a global one a block), ``blocks`` blocks and ``tail`` window layers."""
    cfg = dataclasses.replace(get_config("gemma3-4b-smoke"),
                              local_global_ratio=5,
                              num_layers=6 * blocks + tail)
    assert [st.repeat for st in cfg.plan()] == [blocks, tail]
    return cfg


def _moe_cut(num_layers, arch="deepseek-moe-16b-smoke"):
    cfg = dataclasses.replace(get_config(arch), num_layers=num_layers)
    first = cfg.first_dense_layers
    assert [st.repeat for st in cfg.plan()] == [first, num_layers - first]
    return cfg


def _vlm_cut(blocks):
    """``llama-3.2-vision-90b-smoke`` at the full config's super-block of
    4 self-attention layers and a cross-attention one."""
    cfg = dataclasses.replace(get_config("llama-3.2-vision-90b-smoke"),
                              cross_attn_every=5, num_layers=5 * blocks)
    assert [st.repeat for st in cfg.plan()] == [blocks]
    return cfg


def test_depth_points_are_the_stated_ones():
    points = {arch: dryrun_lib.depth_points(
        tuple(st.repeat for st in get_config(arch).plan()))
        for arch in ("gemma3-4b", "deepseek-moe-16b", "qwen2-7b",
                     "zamba2-2.7b", "deepseek-v3-671b",
                     "llama-3.2-vision-90b")}
    assert points["gemma3-4b"] == ((1, 2), {0: (2, 2), 1: (1, 3)})
    assert points["deepseek-moe-16b"] == ((1, 2), {1: (1, 3)})
    assert points["deepseek-v3-671b"] == ((1, 2), {0: (2, 2), 1: (1, 3)})
    assert points["llama-3.2-vision-90b"] == ((2,), {0: (3,)})
    assert points["qwen2-7b"] == ((2,), {0: (3,)})
    assert points["zamba2-2.7b"] == ((2,), {0: (3,)})
    # 31 layers in three counts for gemma3-4b's 34
    cfg = get_config("gemma3-4b")
    assert sum(dryrun_lib._at_depth(cfg, p).num_layers
               for p in [(1, 2), (2, 2), (1, 3)]) == 31
    with pytest.raises(ValueError, match="no cut"):
        dryrun_lib._at_depth(cfg, (1, 6))       # a tail of 6 is a block


# vmem_flash changes only the prefill's attention loop
DEPTH_CASES = [(cut, shape, fused)
               for cut in ("gemma-3+4", "gemma-2+5", "moe-1+27", "mla-3+5",
                           "vlm-4")
               for shape in DEPTH_SHAPES
               for fused in ([(), ("vmem_flash",)]
                             if shape.kind == "prefill" else [()])]


@pytest.mark.parametrize(
    "cut, shape, fused", DEPTH_CASES,
    ids=[f"{c}-{s.name}-{'vmem_flash' if f else 'plain'}"
         for c, s, f in DEPTH_CASES])
def test_two_stage_depth_by_repeat_equals_the_unrolled_count(cut, shape,
                                                             fused):
    """Counted by repeat, with attention calls replayed, a two-stage plan
    equals every layer counted with every attention call run: FLOPs,
    matmul FLOPs, bytes, ops, argument, output and alias bytes and the
    peak."""
    cfg = {"gemma-3+4": lambda: _gemma_cut(3, 4),
           "gemma-2+5": lambda: _gemma_cut(2, 5),
           "moe-1+27": lambda: _moe_cut(28),
           "mla-3+5": lambda: dataclasses.replace(
               _moe_cut(8, "deepseek-v3-671b-smoke"), first_dense_layers=3),
           "vlm-4": lambda: _vlm_cut(4)}[cut]()
    ctx = ModelContext(remat="full")
    whole = dryrun_lib.count_cell(cfg, shape, ctx, fused_scopes=fused,
                                  unroll=True, replay=False)
    assert dryrun_lib.count_cell(cfg, shape, ctx,
                                 fused_scopes=fused) == whole


def test_replayed_attention_runs_once_per_signature(monkeypatch):
    """A ``prefill_4k`` cut of 3 + 4 blocks (22 layers) runs the plain
    attention loop twice, for the window layers and the global ones;
    the decode step's one-row calls always run."""
    from repro_torch.models import layers
    calls = []
    real = layers.attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], kw.get("window", 0)))
        return real(q, k, v, **kw)
    monkeypatch.setattr(layers, "attention", spy)
    cfg = _gemma_cut(3, 4)
    ctx = ModelContext(remat="full")
    dryrun_lib.count_cell(cfg, DEPTH_SHAPES[2], ctx, unroll=True)
    assert sorted(calls) == [(4096, 0), (4096, 8)]
    calls.clear()
    dryrun_lib.count_cell(cfg, DEPTH_SHAPES[1], ctx, unroll=True)
    assert len(calls) == cfg.num_layers


# --------------------------------- held to the reference's compiled cells
def _dot_flops(hlo_text: str) -> float:
    """The reference's dot FLOPs (tests/test_torch_dryrun.py)."""
    keep = hlo._op_flops
    hlo._op_flops = lambda op, tbl: (hlo._dot_flops(op, tbl)
                                     if op.opcode == "dot" else 0.0)
    try:
        return hlo.analyze(hlo_text, 1)["flops_per_chip"]
    finally:
        hlo._op_flops = keep


STAGE_CELLS = [(arch, shape)
               for arch in ("gemma3-4b-smoke", "deepseek-moe-16b-smoke",
                            "deepseek-v3-671b-smoke",
                            "llama-3.2-vision-90b-smoke")
               for shape in CELLS
               if arch.startswith("gemma") or shape != "long_500k"]


@pytest.fixture(scope="module")
def stage_cells():
    """(arch, shape) -> ((the reference's dot FLOPs, argument bytes) of
    its compiled smoke cell, the port's record of it)."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch, shape in STAGE_CELLS:
        fn, args = jdry.build_cell(arch, shape, mesh,
                                   ctx_overrides={"remat": "full"})
        compiled = fn.lower(*args).compile()
        out[arch, shape] = ((_dot_flops(compiled.as_text()),
                             compiled.memory_analysis()
                             .argument_size_in_bytes),
                            dryrun_lib.run_cell(arch, shape))
    return out


def _attention_products(cfg, spec, B: int, S: int) -> int:
    """FLOPs of one application's QK^T and PV over S query rows: an MLA
    layer's at head dims ``dn + dr`` and ``dv``, a cross-attention
    layer's against the ``num_image_tokens`` rows."""
    H = cfg.num_heads
    if spec.kind == "mla":
        return 2 * B * H * S * S * (cfg.qk_nope_head_dim +
                                    cfg.qk_rope_head_dim + cfg.v_head_dim)
    rows = cfg.num_image_tokens if spec.kind == "cross_attn" else S
    return 2 * (2 * B * H * S * rows * cfg.head_dim)


def _stage_gap(cfg, shape) -> int:
    """The matmul FLOPs the reference's compiled cell has beyond the
    port's, over a plan of attention, MLA and cross-attention layers
    (ROADMAP §3). Both count a MoE layer's ``routed_ep``, every expert
    over its ``cap`` rows, so prefill and decode cells have no gap;

    * in a train step, each application's QK^T and PV once more
      (tests/test_torch_dryrun.py's dense gap; ``_attention_products``),
      and, under the reference's one ``jax.checkpoint`` per block, the
      recompute of the FFN's output product (2·T·d_ff·d) of every layer
      whose output a later layer of its block reads: all but the last of
      a block;
    * less, in a train step with MTP, one unembedding product of the MTP
      loss (2·B·(S-1)·d·Vp): its ``fused_ce`` has one chunk (S - 1 is no
      multiple of 512), whose checkpoint the port recomputes in the
      backward, where XLA merges the reference's recompute of a scan of
      one step with its forward. The MTP layer's attention has no gap:
      its one query block is no scan either."""
    B, S = shape.global_batch, shape.seq_len
    T = B * (1 if shape.kind == "decode" else S)
    train = shape.kind == "train"
    gap = 0
    for st in cfg.plan():
        for j, spec in enumerate(st.layers):
            if not train:
                continue
            gap += st.repeat * _attention_products(cfg, spec, B, S)
            if j < len(st.layers) - 1:
                gap += st.repeat * 2 * T * cfg.d_ff * cfg.d_model
    if train and cfg.mtp_depth:
        gap -= 2 * B * (S - 1) * cfg.d_model * cfg.padded_vocab_size
    return gap


def _unused_argument_bytes(cfg, shape) -> int:
    """Argument bytes the port counts and the reference's compiled cell
    does not: a prefill or decode step reads no MTP parameter, and XLA
    drops unused arguments (as an SSM decode's ``pos``,
    tests/test_torch_dryrun.py)."""
    if shape.kind == "train" or not cfg.mtp_depth:
        return 0
    mtp = model.init(ShapesOnly(), cfg)["mtp"]
    from repro_torch import tree
    return sum(t.numel() * t.element_size() for t in tree.leaves(mtp))


def test_stage_gaps_are_the_stated_numbers():
    moe = get_config("deepseek-moe-16b-smoke")
    # both count routed_ep's E·cap rows: prefill and decode agree
    assert _stage_gap(moe, SHAPES["prefill_32k"]) == 0
    assert _stage_gap(moe, SHAPES["decode_32k"]) == 0
    assert _stage_gap(moe, SHAPES["train_4k"]) == 4 * 2 ** 40 \
        == 4_398_046_511_104
    gemma = get_config("gemma3-4b-smoke")
    assert _stage_gap(gemma, SHAPES["prefill_32k"]) == 0
    assert _stage_gap(gemma, SHAPES["train_4k"]) == \
        4 * 2 ** 40 + 2 ** 35 == 4_432_406_249_472
    # four MLA layers' QK^T (24 wide) and PV (16) at 256 x 4096, 4 heads,
    # less the MTP loss's unembedding at 4095 positions
    mla = get_config("deepseek-v3-671b-smoke")
    assert _stage_gap(mla, SHAPES["prefill_32k"]) == 0
    assert _stage_gap(mla, SHAPES["decode_32k"]) == 0
    assert _stage_gap(mla, SHAPES["train_4k"]) == \
        5 * 2 ** 40 - 256 * 4095 * 2 ** 15 == 5_463_206_789_120
    assert _unused_argument_bytes(mla, SHAPES["decode_32k"]) == 90_624
    # two self-attention layers, two cross-attention layers against 8
    # image rows, and one FFN recompute a block of two
    vlm = get_config("llama-3.2-vision-90b-smoke")
    assert _stage_gap(vlm, SHAPES["prefill_32k"]) == 0
    assert _stage_gap(vlm, SHAPES["train_4k"]) == \
        2 ** 41 + 2 ** 32 + 2 ** 35 == 2_237_677_961_216


@pytest.mark.parametrize("arch, shape", STAGE_CELLS, ids=lambda v: v)
def test_stage_cells_equal_the_references(arch, shape, stage_cells):
    """The smoke cells of the two-stage families and the VLM family:
    argument bytes equal the reference's compiled cell's but for
    ``_unused_argument_bytes``; matmul FLOPs too, but for ``_stage_gap``
    (0 in every prefill and decode cell: the MoE layers' ``routed_ep``
    as the reference compiles it)."""
    (ref_flops, ref_args), rec = stage_cells[arch, shape]
    assert rec["status"] == "ok", rec.get("error")
    cfg = get_config(arch)
    gap = _stage_gap(cfg, SHAPES[shape])
    assert rec["cost"]["matmul_flops_per_chip"] + gap == ref_flops
    assert rec["memory"]["argument_bytes"] - \
        _unused_argument_bytes(cfg, SHAPES[shape]) == ref_args
    assert rec["cost"]["max_loop_trip"] == max(
        st.repeat for st in get_config(arch).plan())


def test_long_context_cells_of_the_two_stage_archs():
    """``long_500k`` runs for ``gemma3-4b`` (``sub_quadratic`` admits the
    local/global family) and is skipped for ``deepseek-moe-16b`` with the
    reference's reason."""
    rec = dryrun_lib.run_cell("gemma3-4b", "long_500k")
    assert rec["status"] == "ok", rec.get("error")
    cfg = get_config("gemma3-4b")
    # 29 window layers of 1024 rows and 5 global ones of 524,288, bf16
    kv = 2 * cfg.num_kv_heads * cfg.head_dim * 2
    caches = (29 * 1024 + 5 * 524288) * kv
    params = sum(t.numel() * t.element_size() for t in _leaves(cfg))
    assert rec["memory"]["argument_bytes"] == params + caches + 4 + 4
    assert rec["memory"]["alias_bytes"] == caches
    for arch in ("deepseek-moe-16b", "deepseek-v3-671b",
                 "llama-3.2-vision-90b"):
        rec = dryrun_lib.run_cell(arch, "long_500k")
        assert rec == jdry.run_cell(arch, "long_500k")
        assert rec["status"] == "skipped"


def _leaves(cfg):
    from repro_torch import tree
    return tree.leaves(model.init(ShapesOnly(), cfg))


# ------------------------------------------------------------ sharding
@pytest.mark.parametrize("arch", ["gemma3-4b", "deepseek-moe-16b",
                                  "deepseek-v3-671b",
                                  "llama-3.2-vision-90b"])
def test_two_stage_sharding_specs_equal_the_references(arch):
    """Every per-layer leaf, the experts' ``[E, ...]`` leaves, ``router``
    and ``sh_*``, the MLA leaves and the cross layers' 0-d ``gate``
    included, gets the reference's spec for its stacked leaf of its stage
    without the repeat axis, and the unstacked MTP module's leaves the
    reference's as they are; the caches (a window layer's ``[B, 1024, 4,
    256]`` beside a global layer's ``[B, S, 4, 256]``, MLA's latent
    pair, a cross layer's ``()``) the reference's cache specs, and the
    image embeddings the reference's batch spec. Full-size shapes on an
    ``AbstractMesh`` (no devices)."""
    sizes = {"data": 16, "model": 16}
    amesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    jcfg, cfg = jget_config(arch), get_config(arch)
    jspec = jsharding.param_specs(jax.eval_shape(
        partial(jmodel.init, cfg=jcfg), jax.random.PRNGKey(0)), amesh)
    spec = sharding.param_specs(model.init(ShapesOnly(), cfg), sizes)
    for name in ("embed", "unembed", "final_ln"):
        assert spec[name] == tuple(jspec[name])
    want = [jspec[f"stage{si}"][f"layer{j}"]
            for si, st in enumerate(cfg.plan()) for _ in range(st.repeat)
            for j in range(len(st.layers))]
    assert len(spec["layers"]) == len(want) == cfg.num_layers
    seen = set()
    for layer, stacked in zip(spec["layers"], want):
        assert set(layer) == set(stacked)
        for part, leaves in layer.items():
            assert set(leaves) == set(stacked[part])
            for leaf, s in leaves.items():
                assert s == tuple(stacked[part][leaf])[1:], (part, leaf)
                seen.add(leaf)
    if cfg.family == "moe":
        assert {"router", "w1", "w2", "w3", "sh_w1", "sh_w2",
                "sh_w3"} <= seen
    if cfg.use_mla:
        assert {"wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "q_ln",
                "kv_ln"} <= seen
    if cfg.cross_attn_every:
        assert "gate" in seen
    assert ("mtp" in spec) == ("mtp" in jspec) == bool(cfg.mtp_depth)
    if cfg.mtp_depth:
        assert {k: v for k, v in spec["mtp"].items()} == \
            jax.tree_util.tree_map(tuple, jspec["mtp"],
                                   is_leaf=lambda x: isinstance(
                                       x, jax.sharding.PartitionSpec))
        assert spec["mtp"]["proj"] == ("data", None)
    for shape in ("decode_32k", "long_500k"):
        jin = jspecs.decode_inputs(jcfg, JSHAPES[shape])
        pin = specs.decode_inputs(cfg, SHAPES[shape])
        jc = jsharding.cache_specs(jin["caches"], amesh)
        ref = [jc[f"stage{si}"][f"layer{j}"]
               for si, st in enumerate(cfg.plan())
               for _ in range(st.repeat) for j in range(len(st.layers))]
        got = sharding.cache_specs(pin["caches"], sizes)
        assert len(got) == len(ref)
        for pair, want_pair in zip(got, ref):
            assert pair == tuple(tuple(w)[1:] for w in want_pair), shape
        rows = {pair[0].shape[1] for pair in pin["caches"] if pair}
        if cfg.family == "local_global":
            assert rows == {1024, SHAPES[shape].seq_len}
        if cfg.use_mla:
            assert {tuple(t.shape[2:]) for pair in pin["caches"]
                    for t in pair} == {(cfg.kv_lora_rank,),
                                       (cfg.qk_rope_head_dim,)}
    for fn in ("train_batch_specs", "prefill_inputs", "decode_inputs"):
        shape = {"train_batch_specs": "train_4k",
                 "prefill_inputs": "prefill_32k",
                 "decode_inputs": "decode_32k"}[fn]
        jin = getattr(jspecs, fn)(jcfg, JSHAPES[shape])
        pin = getattr(specs, fn)(cfg, SHAPES[shape])
        assert ("image_embeds" in pin) == ("image_embeds" in jin) == \
            bool(cfg.cross_attn_every)
        if "image_embeds" in pin:
            assert sharding.batch_specs(
                sizes, {"i": pin["image_embeds"]}) == {"i": tuple(
                    jsharding.batch_specs(amesh, {"i": jin["image_embeds"]})
                    ["i"])}
