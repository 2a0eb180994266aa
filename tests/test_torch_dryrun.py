"""The port's one-card dry-run (``repro_torch.launch.dryrun``) held to the
reference's (``repro.launch.dryrun_lib``) cell by cell.

The reference's side compiles its cells on a 1 x 1 mesh with Auto axes:
``jax.make_mesh`` defaults to Explicit axes on this jax, where the
reference's ``with_sharding_constraint`` calls fail (ROADMAP §3), and the
JAX package is not edited. Its dot FLOPs are read from the compiled HLO
with the port's copy of ``common/hlo.py``, every non-dot op's FLOPs set to
zero."""
import dataclasses
import glob
import json
import math
import os

import jax
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro.launch import dryrun_lib as jdry
from repro.launch import specs as jspecs
from repro_torch.bench.views import roofline
from repro_torch.common import hlo, hw
from repro_torch.distributed import collectives
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import use_device
from repro_torch.distributed import sharding
from repro_torch.kernels import build, ops
from repro_torch.launch import dryrun, dryrun_lib, specs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.layers import ModelContext

SMOKE = "qwen2-7b-smoke"
DENSE = ("qwen2-7b", "granite-3-8b", "deepseek-coder-33b")
CELLS = ("prefill_32k", "decode_32k", "train_4k")


def _dot_flops(hlo_text: str) -> float:
    """The reference's dot FLOPs: ``hlo.analyze`` (trip counts included)
    with every non-dot op's FLOPs zeroed."""
    keep = hlo._op_flops
    hlo._op_flops = lambda op, tbl: (hlo._dot_flops(op, tbl)
                                     if op.opcode == "dot" else 0.0)
    try:
        return hlo.analyze(hlo_text, 1)["flops_per_chip"]
    finally:
        hlo._op_flops = keep


@pytest.fixture(scope="module")
def reference_cells():
    """shape -> (dot FLOPs, argument bytes) of the reference's compiled
    smoke cell."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for shape in CELLS:
        fn, args = jdry.build_cell(SMOKE, shape, mesh,
                                   ctx_overrides={"remat": "full"})
        compiled = fn.lower(*args).compile()
        out[shape] = (_dot_flops(compiled.as_text()),
                      compiled.memory_analysis().argument_size_in_bytes)
    return out


@pytest.fixture(scope="module")
def port_cells():
    """shape -> the port's record of the smoke cell (depth by repeat)."""
    return {shape: dryrun_lib.run_cell(SMOKE, shape) for shape in CELLS}


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_matmul_flops_equal_the_references_dot_flops(shape, reference_cells,
                                                     port_cells):
    rec = port_cells[shape]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["cost"]["matmul_flops_per_chip"] == \
        reference_cells[shape][0]


def test_train_cell_differs_by_one_attention_forward_per_layer(
        reference_cells, port_cells):
    """The reference's compiled step computes each layer's attention
    products (QK^T and PV) once more than the port's eager step: XLA
    keeps the forward's and the remat's in its scanned body, where
    ``torch.utils.checkpoint`` runs the layer once forward and once in the
    backward. The port's count is what the port runs; the gap is pinned
    here (ROADMAP §3)."""
    cfg = get_config(SMOKE)
    shape = SHAPES["train_4k"]
    B, S = shape.global_batch, shape.seq_len
    qk = 2 * B * cfg.num_heads * S * S * cfg.head_dim     # as PV
    gap = cfg.num_layers * 2 * qk
    assert gap == 4_398_046_511_104
    rec = port_cells["train_4k"]
    assert rec["cost"]["matmul_flops_per_chip"] + gap == \
        reference_cells["train_4k"][0]


@pytest.mark.parametrize("shape", CELLS)
def test_argument_bytes_equal_the_references(shape, reference_cells,
                                             port_cells):
    assert port_cells[shape]["memory"]["argument_bytes"] == \
        reference_cells[shape][1]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", DENSE)
def test_model_flops_equal_the_references(arch, shape):
    assert specs.model_flops(get_config(arch), SHAPES[shape]) == \
        jspecs.model_flops(jget_config(arch), JSHAPES[shape])


@pytest.mark.parametrize("arch", DENSE)
def test_long_500k_is_skipped_with_the_references_reason(arch):
    rec = dryrun_lib.run_cell(arch, "long_500k")
    assert rec == jdry.run_cell(arch, "long_500k")
    assert rec["status"] == "skipped"


def test_other_families_and_multi_pod_are_skipped():
    """Every architecture of the reference is counted: MLA with MTP and
    the VLM family too (their smoke cells are held to the reference's in
    tests/test_torch_dryrun_stages.py), and on the multi-pod mesh too (a
    rank of 2 x 16 x 16, tests/test_torch_dryrun_mesh.py); only
    ``long_500k`` of the full-attention archs (below) is skipped."""
    assert list_configs() == jlist_configs() == dryrun_lib.all_archs()
    assert len(dryrun_lib.all_archs()) == 10
    # the MoE cells are counted (even load on meta tensors), MLA's and
    # the VLM family's too
    for arch in ("deepseek-moe-16b", "deepseek-v3-671b",
                 "llama-3.2-vision-90b"):
        rec = dryrun_lib.run_cell(arch, "decode_32k")
        assert rec["status"] == "ok", rec.get("error")
    for arch in ("qwen2-7b", "deepseek-moe-16b", "deepseek-v3-671b"):
        rec = dryrun_lib.run_cell(arch, "decode_32k", multi_pod=True)
        assert rec["status"] == "ok", rec.get("error")
        assert (rec["mesh"], rec["num_devices"]) == \
            ({"pod": 2, "data": 16, "model": 16}, 512)
        assert rec["collectives"]["num_collectives"] > 0
    rec = dryrun_lib.run_cell("qwen2-7b", "long_500k", multi_pod=True)
    assert rec == jdry.run_cell("qwen2-7b", "long_500k", multi_pod=True)
    assert rec["status"] == "skipped"


# Depth by repeat against every layer counted. Train and prefill run at
# shorter shapes than the matrix's (the same ops, fewer and smaller
# attention blocks) to keep the file quick.
DEPTH_SHAPES = [ShapeConfig("train_512", "train", 512, 8),
                SHAPES["decode_32k"],
                ShapeConfig("prefill_4k", "prefill", 4096, 32)]


@pytest.mark.parametrize("fused", [(), ("vmem_flash",)],
                         ids=["plain", "vmem_flash"])
@pytest.mark.parametrize("shape", DEPTH_SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("depth", [2, 3, 5, 7])
def test_depth_by_repeat_equals_the_unrolled_count(depth, shape, fused):
    """FLOPs, bytes, argument and output bytes are linear in depth, and
    the peak falls at the same point of each layer from the second on,
    so all agree exactly (depths 2 and 3 are counted whole either way);
    the unrolled count runs every attention call, the count by repeat
    replays them."""
    cfg = dataclasses.replace(get_config(SMOKE), num_layers=depth)
    ctx = ModelContext(remat="full")
    whole = dryrun_lib.count_cell(cfg, shape, ctx, fused_scopes=fused,
                                  unroll=True, replay=False)
    by_repeat = dryrun_lib.count_cell(cfg, shape, ctx, fused_scopes=fused)
    assert by_repeat == whole


def test_depth_by_repeat_keeps_the_optimizers_peak_apart():
    """A train cell whose peak moves with depth from the backward to the
    optimizer's update (at 128 x 4 tokens the backward's peak is the
    larger at depths 2 and 3, AdamW's at 20: its parameters, moments
    and their new copies grow faster a layer): each region's peak is
    extrapolated on its own, and the cell's peak equals the unrolled
    count's, AdamW's."""
    cfg = dataclasses.replace(get_config(SMOKE), num_layers=20)
    shape = ShapeConfig("train_128", "train", 128, 4)
    ctx = ModelContext(remat="full")
    for depth, optimizer_wins in ((3, False), (20, True)):
        fn, args = dryrun_lib._build(
            dataclasses.replace(cfg, num_layers=depth), shape, ctx)
        c = dryrun_lib.count(fn, args)
        assert (c["optimizer_peak_bytes"] > c["step_peak_bytes"]) == \
            optimizer_wins, depth
    assert c["peak_bytes"] == c["optimizer_peak_bytes"]
    whole = dryrun_lib.count_cell(cfg, shape, ctx, unroll=True,
                                  replay=False)
    assert whole["peak_bytes"] == c["peak_bytes"]
    assert dryrun_lib.count_cell(cfg, shape, ctx) == whole


@pytest.mark.parametrize("shape", [ShapeConfig("prefill_4k", "prefill",
                                               4096, 32),
                                   ShapeConfig("train_512", "train", 512,
                                               8)], ids=lambda s: s.name)
def test_vmem_flash_keeps_the_flops_and_lowers_the_bytes(shape):
    cfg = get_config(SMOKE)
    ctx = ModelContext(remat="full")
    plain = dryrun_lib.count_cell(cfg, shape, ctx)
    flash = dryrun_lib.count_cell(cfg, shape, ctx,
                                  fused_scopes=("vmem_flash",))
    assert flash["flops"] == plain["flops"]
    assert flash["matmul_flops"] == plain["matmul_flops"]
    assert flash["peak_bytes"] == plain["peak_bytes"]
    assert flash["bytes"] < plain["bytes"]


def test_vmem_flash_reads_the_scopes_inputs_once():
    """One attention call: under ``vmem_flash`` the KV-block body reads
    each of its inputs once, whatever the number of blocks: every q block
    in float32, k and v in bf16, each q block's positions and running
    state (m, l, acc in float32); what it makes inside is free."""
    from repro_torch.models import layers
    meta = torch.device("meta")
    B, S, H, KV, D = 2, 512, 4, 2, 16
    q = torch.empty(B, S, H, D, dtype=torch.bfloat16, device=meta)
    k = torch.empty(B, S, KV, D, dtype=torch.bfloat16, device=meta)
    v = torch.empty(B, S, KV, D, dtype=torch.bfloat16, device=meta)

    def attn(q, k, v):
        return layers.attention(q, k, v, causal=True, q_chunk=128,
                                k_chunk=128)
    plain = dryrun_lib.count(attn, (q, k, v))
    flash = dryrun_lib.count(attn, (q, k, v), fused_scopes=("vmem_flash",))
    assert flash["flops"] == plain["flops"]
    assert flash["bytes"] < plain["bytes"]
    # the same count with the scope's reads dropped: the ops outside it
    outside = dryrun_lib.Counter(("vmem_flash",))
    outside._fused_read_bytes = lambda t: 0
    dryrun_lib._track_arguments((q, k, v), outside)
    with outside:
        attn(q, k, v)
    state = B * H * S * 4 * 2 + B * H * S * D * 4          # m, l, acc
    inputs = q.numel() * 4 + (k.numel() + v.numel()) * 2 + S * 8 + state
    assert flash["bytes"] - outside.bytes == inputs


# ------------------------------------- the SSM, hybrid and audio families
FAMILY_CELLS = [(arch, shape)
                for arch in ("mamba2-370m-smoke", "zamba2-2.7b-smoke",
                             "musicgen-medium-smoke")
                for shape in CELLS + ("long_500k",)
                if not (arch.startswith("musicgen") and shape == "long_500k")]


@pytest.fixture(scope="module")
def family_cells():
    """(arch, shape) -> ((the reference's dot FLOPs, argument bytes) of its
    compiled smoke cell, the port's record of it)."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch, shape in FAMILY_CELLS:
        fn, args = jdry.build_cell(arch, shape, mesh,
                                   ctx_overrides={"remat": "full"})
        compiled = fn.lower(*args).compile()
        out[arch, shape] = ((_dot_flops(compiled.as_text()),
                             compiled.memory_analysis()
                             .argument_size_in_bytes),
                            dryrun_lib.run_cell(arch, shape))
    return out


def _train_gap(cfg, shape) -> int:
    """The matmul FLOPs the reference's compiled train step has beyond
    the port's eager one (ROADMAP §3):

    * each attention application's QK^T and PV once more (the dense
      cells' gap, which the train-cell test above pins);
    * in each Mamba2 layer, the gradients of the SSD's two chunk decays
      (``decay_states`` and ``state_decay``, ``[B, S, H]``): each a sum
      over the head dim of a product, which XLA emits as a dot op and
      autograd as a multiply and a sum (pointwise FLOPs): 2 x 2·B·S·H·P;
    * under the reference's one ``jax.checkpoint`` per super-block, the
      remat recomputes the output projection of every layer whose output
      a later layer of the block reads: each Mamba2 layer of the hybrid
      family's block (the shared attention comes last); the port
      checkpoints each layer, and ``torch.utils.checkpoint`` stops its
      recompute at the last tensor the backward needs: 2·B·S·d_in·d."""
    B, S = shape.global_batch, shape.seq_len
    specs = [spec for st in cfg.plan() for _ in range(st.repeat)
             for spec in st.layers]
    n_attn = sum(spec.kind == "attn" for spec in specs)
    n_mamba = len(specs) - n_attn
    attn = 2 * (2 * B * cfg.num_heads * S * S * cfg.head_dim)
    decays = 2 * (2 * B * S * cfg.ssm_heads * cfg.ssm_head_dim)
    out_proj = 2 * B * S * cfg.ssm_d_inner * cfg.d_model \
        if cfg.family == "hybrid" else 0
    return n_attn * attn + n_mamba * (decays + out_proj)


@pytest.mark.parametrize("arch, shape", FAMILY_CELLS,
                         ids=lambda v: v)
def test_family_cells_equal_the_references(arch, shape, family_cells):
    """The smoke cells of the SSM, hybrid and audio families: matmul
    FLOPs and argument bytes of the reference's compiled cell. The
    port's explicit SSD contractions (``models/ssm.py``) follow XLA's
    order, so prefill and decode agree to the FLOP; the train step
    differs by ``_train_gap``, and an SSM decode step by the reference's
    unused ``pos`` argument, which XLA drops from its compiled arguments
    (the port counts it as the reference's int32)."""
    (ref_flops, ref_args), rec = family_cells[arch, shape]
    assert rec["status"] == "ok", rec.get("error")
    cfg = get_config(arch)
    gap = _train_gap(cfg, SHAPES[shape]) if shape == "train_4k" else 0
    assert rec["cost"]["matmul_flops_per_chip"] + gap == ref_flops
    unused_pos = specs.SCALAR_BYTES if (
        cfg.family == "ssm" and SHAPES[shape].kind == "decode") else 0
    assert rec["memory"]["argument_bytes"] - unused_pos == ref_args


def test_family_train_gaps_are_the_stated_numbers():
    shape = SHAPES["train_4k"]
    assert _train_gap(get_config("mamba2-370m-smoke"), shape) == 2 ** 31
    assert _train_gap(get_config("zamba2-2.7b-smoke"), shape) == \
        2 ** 41 + 2 ** 36 + 2 ** 31 == 2_269_890_215_936
    assert _train_gap(get_config("musicgen-medium-smoke"), shape) == \
        _train_gap(get_config(SMOKE), shape) == 4_398_046_511_104


def test_family_long_context_cells():
    """``long_500k`` runs for the SSM and hybrid archs and is skipped for
    the audio one with the reference's reason."""
    for arch in ("mamba2-370m", "zamba2-2.7b"):
        rec = dryrun_lib.run_cell(arch, "long_500k")
        assert rec["status"] == "ok", rec.get("error")
        assert rec["cost"]["max_loop_trip"] == \
            get_config(arch).plan()[0].repeat
    rec = dryrun_lib.run_cell("musicgen-medium", "long_500k")
    assert rec == jdry.run_cell("musicgen-medium", "long_500k")
    assert rec["status"] == "skipped"


@pytest.mark.parametrize("shape", DEPTH_SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("blocks", [2, 3, 4])
def test_depth_by_repeat_equals_the_unrolled_count_for_a_super_block(
        blocks, shape):
    """``zamba2``'s stage repeats a super-block of Mamba2 layers and the
    shared attention; counted at 2 and 3 blocks and extrapolated, it
    equals every block counted (the shared parameters count once at
    every depth)."""
    base = get_config("zamba2-2.7b-smoke")
    cfg = dataclasses.replace(base,
                              num_layers=blocks * base.shared_attn_every)
    assert cfg.plan()[0].repeat == blocks
    ctx = ModelContext(remat="full", ssd_chunk=64)
    whole = dryrun_lib.count_cell(cfg, shape, ctx, unroll=True,
                                  replay=False)
    by_repeat = dryrun_lib.count_cell(cfg, shape, ctx)
    assert by_repeat == whole


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-370m",
                                  "musicgen-medium"])
def test_family_sharding_specs_equal_the_references(arch):
    """Each per-layer leaf gets the reference's spec for its stacked leaf
    without the repeat axis, and a shared leaf (``stage0_shared``, no
    repeat axis in either package) the reference's spec as it is; the
    Mamba2 caches get the reference's cache specs without the repeat
    axis. Full-size shapes on an ``AbstractMesh`` (no devices)."""
    from functools import partial
    from repro.distributed import sharding as jsharding
    from repro.models import model as jmodel
    from repro_torch.models import model
    from repro_torch.models.layers import ShapesOnly
    sizes = {"data": 16, "model": 16}
    amesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    jcfg, cfg = jget_config(arch), get_config(arch)
    jspec = jsharding.param_specs(jax.eval_shape(
        partial(jmodel.init, cfg=jcfg), jax.random.PRNGKey(0)), amesh)
    params = model.init(ShapesOnly(), cfg)
    spec = sharding.param_specs(params, sizes)
    shared = [k for k in spec if k.endswith("_shared")]
    assert shared == (["stage0_shared"] if cfg.family == "hybrid" else [])
    for key in shared:
        for j, layer in spec[key].items():
            for part, leaves in layer.items():
                for leaf, s in leaves.items():
                    assert s == tuple(jspec[key][j][part][leaf]), leaf
    stage = cfg.plan()[0]
    own = [f"layer{j}" for j, sp in enumerate(stage.layers)
           if not sp.shared]
    assert len(spec["layers"]) == stage.repeat * len(own)
    for i, layer in enumerate(spec["layers"]):
        stacked = jspec["stage0"][own[i % len(own)]]
        assert set(layer) == set(stacked)
        for part, leaves in layer.items():
            for leaf, s in leaves.items():
                assert s == tuple(stacked[part][leaf])[1:], (part, leaf)
    for shape in ("decode_32k", "long_500k"):
        jin = jspecs.decode_inputs(jcfg, JSHAPES[shape])
        pin = specs.decode_inputs(get_config(arch), SHAPES[shape])
        jc = jsharding.cache_specs(jin["caches"], amesh)["stage0"]
        pc = sharding.cache_specs(pin["caches"], sizes)
        per = [f"layer{j}" for j in range(len(stage.layers))]
        for i, pair in enumerate(pc):
            want = jc[per[i % len(per)]]
            assert pair == tuple(tuple(w)[1:] for w in want), (shape, i)


def test_full_width_decode_cell():
    rec = dryrun_lib.run_cell("qwen2-7b", "decode_32k")
    assert rec["status"] == "ok", rec.get("error")
    cfg = get_config("qwen2-7b")
    shape = SHAPES["decode_32k"]
    B, S = shape.global_batch, shape.seq_len
    params = sum(t.numel() * t.element_size() for t in _param_leaves(cfg))
    caches = cfg.num_layers * 2 * B * S * cfg.num_kv_heads * cfg.head_dim * 2
    mem = rec["memory"]
    assert mem["argument_bytes"] == params + caches + B * 4 + 4
    assert mem["alias_bytes"] == caches            # written in place
    assert mem["fits_hbm"] is False                 # 257 GB of caches
    assert rec["cost"]["max_loop_trip"] == cfg.num_layers == 28
    assert rec["counted"] == "plain" and rec["compile_s"] == 0.0
    assert rec["roofline"]["dominant"] == "memory_s"
    assert rec["roofline"]["bound_s"] == pytest.approx(
        rec["cost"]["bytes_per_chip"] / hw.H100_SXM.hbm_bandwidth)
    assert rec["model_flops_total"] == jspecs.model_flops(
        jget_config("qwen2-7b"), JSHAPES["decode_32k"])
    # one query row a layer against the whole cache, plus the projections
    d, Vp = cfg.d_model, cfg.padded_vocab_size
    per_layer = 2 * B * d * (cfg.num_heads + 2 * cfg.num_kv_heads) * \
        cfg.head_dim + 2 * B * cfg.num_heads * cfg.head_dim * d + \
        3 * 2 * B * d * cfg.d_ff + \
        2 * 2 * B * cfg.num_heads * S * cfg.head_dim
    assert rec["cost"]["matmul_flops_per_chip"] == \
        cfg.num_layers * per_layer + 2 * B * d * Vp


def _param_leaves(cfg):
    from repro_torch import tree
    from repro_torch.models import model
    from repro_torch.models.layers import ShapesOnly
    return tree.leaves(model.init(ShapesOnly(), cfg))


def test_cli_writes_records_the_roofline_view_reads(tmp_path, monkeypatch,
                                                    capsys):
    out = str(tmp_path / "dry")
    code = dryrun.main(["--arch", SMOKE, "--arch", "llama-3.2-vision-90b",
                        "--shape", "decode_32k", "--shape", "long_500k",
                        "--out", out])
    assert code == 0
    assert "dry-run: 4 ok, 4 skipped, 0 errors" in capsys.readouterr().out
    names = sorted(os.path.basename(p) for p in glob.glob(out + "/*.json"))
    assert names == sorted(f"{a}__{s}__{m}.json"
                           for a in (SMOKE, "llama-3.2-vision-90b")
                           for s in ("decode_32k", "long_500k")
                           for m in ("pod", "multipod"))
    recs = {n: json.load(open(os.path.join(out, n))) for n in names}
    for n, r in recs.items():
        want = "ok" if "__decode_32k__" in n else "skipped"
        assert r["status"] == want, n
        assert r["mesh_name"] == n.split("__")[2][:-5]
    monkeypatch.setattr(roofline, "DRYRUN_DIR", out)
    monkeypatch.chdir(tmp_path)
    rows = roofline.run()
    assert rows[0] == ("roofline.matrix", 0.0,
                       "pod ok=2 skipped=2 err=0; multipod ok=2")
    cell = [r for r in rows if r[0] == f"roofline.{SMOKE}.decode_32k"]
    assert len(cell) == 1 and cell[0][1] > 0
    # a second run reads the records back
    assert dryrun.main(["--arch", SMOKE, "--shape", "decode_32k",
                        "--single-pod-only", "--out", out]) == 0
    assert "[cached]" in capsys.readouterr().out


#: context fields the dry-run takes, each with a value that changes what
#: a MoE cell counts (the default is ``routed_ep`` at 1.25)
ACCEPTED_CTX = {"moe_impl": "dense", "capacity_factor": 2.0}
#: the reference's layout hints, which the dry-run takes and which change
#: no count over its one rank: each with the overrides it counts as
#: (``no_tp`` makes the MoE route dense unless the caller sets it)
HINTS = {"no_tp": {"moe_impl": "dense"}, "seq_shard_residual": {}}


@pytest.mark.parametrize("key", ["no_tp", "moe_impl", "seq_shard_residual",
                                 "capacity_factor", "data_axes",
                                 "not_a_field"])
def test_reference_only_and_unknown_ctx_keys_raise(key, tmp_path, capsys):
    """The mesh's fields and unknown fields raise; ``moe_impl`` and
    ``capacity_factor`` are the dry-run's to set, and change a MoE cell's
    count by the expert rows they run: ``E·cap`` a layer for
    ``routed_ep``, ``T·k`` for the drop-free ``routed``; the layout hints
    are accepted and change no count over one rank."""
    if key in HINTS:
        arch, shape = "deepseek-moe-16b-smoke", "decode_32k"
        rec = dryrun_lib.run_cell(arch, shape, ctx_overrides={key: True})
        same = dryrun_lib.run_cell(arch, shape, ctx_overrides=HINTS[key])
        assert rec["status"] == same["status"] == "ok"
        assert rec["cost"] == same["cost"]
        ctx = sharding.make_context({"data": 1, "model": 1}, **{key: True})
        assert getattr(ctx, key) and ctx.tp_size == 1
        assert not ctx.seq_parallel
        return
    if key in ACCEPTED_CTX:
        arch, shape = "deepseek-moe-16b-smoke", "decode_32k"
        cfg = get_config(arch)
        base = dryrun_lib.run_cell(arch, shape)
        rec = dryrun_lib.run_cell(arch, shape,
                                  ctx_overrides={key: ACCEPTED_CTX[key]})
        assert base["status"] == rec["status"] == "ok"
        T = SHAPES[shape].global_batch
        E, k = cfg.num_experts, cfg.experts_per_token

        def rows(cf):
            return E * math.ceil(T * k / E * cf)
        new_rows = T * k if key == "moe_impl" else rows(2.0)
        n_moe = cfg.num_layers - cfg.first_dense_layers
        assert rec["cost"]["matmul_flops_per_chip"] - \
            base["cost"]["matmul_flops_per_chip"] == \
            6 * cfg.d_model * cfg.moe_d_ff * n_moe * (new_rows - rows(1.25))
        ctx = sharding.make_context({"data": 1, "model": 1},
                                    **{key: ACCEPTED_CTX[key]})
        assert getattr(ctx, key) == ACCEPTED_CTX[key]
        return
    with pytest.raises(ValueError, match=key):
        dryrun_lib.run_cell(SMOKE, "decode_32k", ctx_overrides={key: 1})
    with pytest.raises(ValueError,
                       match="ROADMAP" if key != "not_a_field" else "unknown"):
        sharding.make_context({"data": 1, "model": 1}, **{key: 1})
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", SMOKE, "--shape", "decode_32k", "--ctx",
                     json.dumps({key: 1}), "--out", str(tmp_path)])
    assert e.value.code == 2
    assert key in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_no_kernel_is_reached(monkeypatch):
    def refuse(name):
        raise AssertionError(f"the dry-run reached kernel {name}")
    monkeypatch.setattr(build, "kernel", refuse)
    before = dict(ops.LAUNCHES)
    for ctx in ({}, {"fused_scopes": ["vmem_flash"], "flash_kernel": True}):
        for shape in CELLS[1:]:
            rec = dryrun_lib.run_cell(SMOKE, shape, ctx_overrides=ctx)
            assert rec["status"] == "ok", rec.get("error")
    assert dict(ops.LAUNCHES) == before


def test_the_mesh_is_one_card():
    """The production meshes: the pod record's one card, and the
    reference's multi-pod mesh (counted one rank at a time); a live mesh
    of more than one rank, three axes too, needs a world of its size."""
    mesh = make_production_mesh()
    assert (mesh.shape, mesh.size) == ({"data": 1, "model": 1}, 1)
    multi = make_production_mesh(multi_pod=True)
    assert (multi.shape, multi.size) == (
        {"pod": 2, "data": 16, "model": 16}, 512)
    ctx = sharding.make_context(multi.shape)
    assert (ctx.data_axes, ctx.tp_size, ctx.data_axes_size,
            ctx.mesh.coords) == (("pod", "data"), 16, 32, (0, 0, 0))
    assert ctx.mesh.get_group("model") == collectives.CountedGroup(
        "model", 16)
    with use_device("cpu"):
        with pytest.raises(ValueError, match="2 x 1 x 2 mesh needs an "
                           "initialised world of 4"):
            make_host_mesh(data=1, model=2, pod=2)
        assert not torch.distributed.is_initialized()
        try:
            host = make_host_mesh()
            assert dict(zip(host.mesh_dim_names, host.shape)) == \
                {"data": 1, "model": 1}
            with pytest.raises(ValueError, match="world of 2"):
                make_host_mesh(data=2)
            with pytest.raises(ValueError, match="world of 4"):
                make_host_mesh(data=2, pod=2)
        finally:
            torch.distributed.destroy_process_group()
