"""The port's example entry points (``repro_torch.examples``) on the CPU,
held against what the reference's APIs give on the same inputs.

Each runs at a small size under ``--device cpu``: ``quickstart`` (every
field but the timings equals the reference's for the counterpart
paths; the decision report equals ``repro.core.decision``'s over the
same records), ``serve_lm`` (greedy ids equal
``repro.serve.engine.generate``'s in float32, the reference's
parameters carried across by ``models.convert``, at ``qwen2-7b-smoke``
and at the VLM's ``-smoke`` config with its image embeddings),
``storage_loader`` (exact resume), ``autotune_workers`` (every path
swept) and ``serve_decode`` (no failures). Without a card and without
``--device cpu`` every entry point exits 2.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codecs import ExecContext as JExecContext
from repro.codecs import eligible as jeligible
from repro.codecs import get_decoder as jget_decoder
from repro.codecs import open_decoder as jopen_decoder
from repro.configs import get_config as jget_config
from repro.core import decision as jdecision
from repro.core import protocols as jprotocols
from repro.core.schema import RunRecord as JRunRecord
from repro.jpeg.corpus import build_corpus as jbuild_corpus
from repro.models import layers as JL
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro_torch.codecs import decoder_names
from repro_torch.configs import get_config
from repro_torch.examples import (autotune_workers, quickstart, serve_decode,
                                  serve_lm, storage_loader)
from repro_torch.models import convert

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
EXAMPLES = ("quickstart", "serve_decode", "serve_lm", "storage_loader",
            "autotune_workers")
#: the reference's engines for the quickstart's three decodes
COUNTERPART = {"numpy-fast": "numpy-fast", "torch-fused": "jnp-fused",
               "cuda-idct": "pallas-idct"}
TIMINGS = ("throughput_mean", "throughput_std", "samples")
LOADER_TIMINGS = ("latency_p50_s", "latency_p99_s")


def _fields(d: dict) -> dict:
    """A record's JSON without its timings; ``samples`` keeps its
    length (tests/test_torch_protocols.py's rule)."""
    d = dict(d, n_samples=len(d["samples"]))
    for key in TIMINGS:
        d.pop(key)
    if "loader" in d["meta"]:
        loader = {k: v for k, v in d["meta"]["loader"].items()
                  if k not in LOADER_TIMINGS}
        d["meta"] = dict(d["meta"], loader=loader)
    return d


# -------------------------------------------------------------- quickstart
@pytest.fixture(scope="module")
def quick():
    return quickstart.main(CPU, corpus_n=12, st_repeats=1, loader_repeats=1)


def test_quickstart_decodes_like_the_reference(quick):
    corpus = jbuild_corpus(12, seed=0)
    assert quick["corpus"] == {"n": 12, "rare_index": corpus.rare_index}
    assert list(quick["decodes"]) == list(COUNTERPART)
    for name, theirs in COUNTERPART.items():
        with jopen_decoder(theirs, context=JExecContext.INLINE) as dec:
            img = dec.decode(corpus.files[0]).unwrap()
            bucket = dec.probe(corpus.files[0])[:2]
        assert quick["decodes"][name] == {
            "shape": list(img.shape), "dtype": str(img.dtype),
            "bucket": list(bucket)}, name
    with jopen_decoder("strict-fast") as dec:
        res = dec.decode(corpus.files[corpus.rare_index])
    assert quick["strict"] == {"kind": res.kind, "reason": res.reason}
    assert quick["strict"]["kind"] == "skip"


def test_quickstart_eligibility_is_the_references_with_torch_for_jax(quick):
    verdict = jeligible(jget_decoder("jnp-fused").caps,
                        JExecContext.PROCESS_POOL)
    mine = quick["eligible"]
    assert mine["ok"] is bool(verdict) is False
    assert mine["reason"].replace("'torch'", "'jnp'").replace(
        "a CUDA context", "jax runtime state") == verdict.reason


def test_quickstart_records_and_report_are_the_references(quick):
    corpus = jbuild_corpus(12, seed=0)
    names = list(quickstart.PROTOCOL_PATHS)
    want = jprotocols.SingleThreadProtocol(corpus, repeats=1).run(names)
    loader = jprotocols.LoaderProtocol(corpus, repeats=1)
    want += [loader.run_path(n, w) for n in names
             for w in quickstart.LOADER_WORKERS]
    assert [_fields(r) for r in quick["records"]] == \
        [_fields(r.to_json()) for r in want]
    assert quick["single_thread"].keys() == set(names)
    assert quick["single_thread"]["strict-fast"]["skips"] == 1
    # the decision report is what the reference computes from the same
    # records (its leaders and tier rank this run's timings)
    rec = jdecision.recommend([JRunRecord.from_json(r)
                               for r in quick["records"]])
    assert quick["disagreement"] == rec["protocol_disagreement"]["live-host"]
    assert quick["tier"] == [t.decoder for t in rec["tier"]]
    assert "strict-fast" not in quick["tier"]


# ---------------------------------------------------------------- serve_lm
LM_ARGS = CPU + ["--batch", "2", "--prompt-len", "16", "--new-tokens", "6"]


def _reference_params(arch, open_gates=False):
    jcfg = dataclasses.replace(jget_config(arch), dtype="float32")
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    jp = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    if open_gates:
        # the cross-attention gates are 0 at init, where the image is
        # unread: open them (tests/test_torch_vlm.py's fixture)
        gate = np_params["stage0"]["layer1"]["attn"]["gate"]
        assert not gate.any()
        np_params["stage0"]["layer1"]["attn"]["gate"] = (
            0.5 + np.random.RandomState(3).rand(*gate.shape)
        ).astype(gate.dtype)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, np_params), cfg,
            convert.import_reference_params(np_params, cfg))


@pytest.mark.parametrize("arch, vlm", [
    ("qwen2-7b-smoke", False), ("llama-3.2-vision-90b-smoke", True)])
def test_serve_lm_ids_equal_the_references(arch, vlm):
    jcfg, jparams, cfg, params = _reference_params(arch, open_gates=vlm)
    got = serve_lm.main(LM_ARGS + ["--arch", arch], dtype="float32",
                        params=params)
    prompt, embeds = serve_lm.inputs(cfg, 2, 16, torch.device("cpu"))
    assert (embeds is not None) == vlm
    kw = {}
    if vlm:
        assert embeds.dtype == torch.bfloat16
        kw["image_embeds"] = jnp.asarray(embeds.float().numpy()).astype(
            jnp.bfloat16)
    want = jengine.generate(jparams, jnp.asarray(prompt.numpy(), jnp.int32),
                            jcfg, JL.ModelContext(q_chunk=64, k_chunk=64),
                            max_new_tokens=6, **kw)
    assert got["shape"] == [2, 6] and got["dtype"] == "float32"
    np.testing.assert_array_equal(np.asarray(got["ids"]), np.asarray(want))
    assert got["prefill_s"] > 0 and got["decode_s"] > 0
    assert "peak_bytes" not in got          # no card, no device memory


def test_serve_lm_defaults_are_the_references_and_seeded():
    """The reference's defaults (qwen2-7b-smoke, 4 x 32, 24 new tokens)
    on the model's own dtype; the same seeds give the same ids."""
    a = serve_lm.main(CPU)
    b = serve_lm.main(CPU)
    assert a["arch"] == "qwen2-7b-smoke" and a["dtype"] == "bfloat16"
    assert a["shape"] == [4, 24] and a["ids"] == b["ids"]
    vocab = get_config("qwen2-7b-smoke").padded_vocab_size
    assert all(0 <= t < vocab for row in a["ids"] for t in row)


# ---------------------------------------------------- loader and autotune
def test_storage_loader_resumes_exactly():
    out = storage_loader.main(CPU, corpus_n=16)
    assert out["parity"] and out["records"] == 16
    assert out["fingerprint"] == out["corpus_fingerprint"]
    assert out["handle"] == "_ShardHandle" and out["restored_step"] == 1
    labels = list(jbuild_corpus(16, seed=0).labels)
    assert len(out["first"]) == 8
    assert sorted(out["first"] + out["rest"]) == sorted(labels)
    assert out["memory_img_s"] > 0 and out["shard_img_s"] > 0


def test_autotune_workers_sweeps_every_path():
    out = autotune_workers.main(CPU, corpus_n=12, candidates=(0, 2),
                                max_items=8)
    assert out["candidates"] == [0, 2]
    assert list(out["paths"]) == list(autotune_workers.PATHS)
    for res in out["paths"].values():
        assert res["best"] in (0, 2) and res["peak_workers"] in (0, 2)
        assert sorted(res["sweep"]) == [0, 2]
        assert all(m > 0 for m, _ in res["sweep"].values())
    assert out["cpu_count"] == os.cpu_count()
    assert autotune_workers.CANDIDATES == (0, 2, 4, 8)


# ------------------------------------------------------------ serve_decode
def test_serve_decode_serves_every_request():
    out = serve_decode.main(CPU + ["--clients", "2", "--requests", "20",
                                   "--corpus", "10", "--metrics-port", "0"])
    svc = out["stats"]["service"]
    assert svc["failed"] == 0 and svc["requests"] == 40
    assert svc["completed"] + svc["shed"] == 40
    assert sum(c["served"] + c["shed"] for c in out["clients"].values()) == 40
    assert out["arms"] == decoder_names()
    assert set(out["stats"]["router"]) == set(decoder_names())
    assert out["router_best"] in out["arms"]
    assert any(ln.startswith("service_requests") for ln in
               out["metrics_lines"])


# -------------------------------------------------- no hidden CPU fallback
@pytest.mark.parametrize("name", EXAMPLES)
def test_without_a_card_main_exits_2(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = sys.modules[f"repro_torch.examples.{name}"]
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert e.value.code == 2
    assert "no CUDA card" in capsys.readouterr().err


@pytest.mark.parametrize("module", ["repro_torch.launch.train",
                                    "repro_torch.train.vision_pipeline"])
def test_without_a_card_the_launchers_exit_2(module, monkeypatch, capsys):
    """The launchers share the examples' guard (``device.entry_device``):
    ``launch.train``'s ``main`` returns 2, ``vision_pipeline``'s exits 2."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(module).main
    if module.endswith("launch.train"):
        assert main([]) == 2
    else:
        with pytest.raises(SystemExit) as e:
            main([])
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert "no CUDA card" in err and "--device cpu" in err


@pytest.fixture(scope="module")
def entry_points():
    """``python -m repro_torch.examples.<name>`` for all five at once,
    with no flag: the card, which this machine lacks."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{name}"], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in EXAMPLES}
    try:
        yield {name: (p.communicate(timeout=300), p.returncode)
               for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.mark.parametrize("name", EXAMPLES)
def test_the_entry_point_exits_2_without_a_card(name, entry_points):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the entry point would run on it")
    (stdout, stderr), rc = entry_points[name]
    assert rc == 2, stderr
    assert "no CUDA card" in stderr and "--device cpu" in stderr
    assert stdout == ""
