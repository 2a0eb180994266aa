"""Quickstart: encode a JPEG corpus, decode it through capability-typed
decoder sessions, benchmark the two protocols, and get an operational
recommendation: the paper's workflow in one script.

Port of the reference's ``examples/quickstart.py``. The front door is
``repro_torch.codecs``: ``open_decoder(name, context=...)`` returns a
session whose ``decode`` yields a typed outcome (image | skip | error),
and the ``eligible(caps, context)`` resolver decides which decoder may
run where. ``torch-fused`` and ``cuda-idct`` stand in for the
reference's ``jnp-fused`` and ``pallas-idct``; on the card ``cuda-idct``
launches the ``idct8x8`` kernel once per component of the image.

Run on the card (``--device cpu`` for the CPU):

    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

from repro_torch.codecs import (ExecContext, eligible, get_decoder,
                                open_decoder)
from repro_torch.core import decision
from repro_torch.core.protocols import LoaderProtocol, SingleThreadProtocol
from repro_torch.device import add_device_flag, on_device
from repro_torch.jpeg.corpus import build_corpus

#: one image through three engines (the reference's numpy-fast,
#: jnp-fused and pallas-idct)
ENGINES = ("numpy-fast", "torch-fused", "cuda-idct")
#: the decoders of the two protocols, as in the reference
PROTOCOL_PATHS = ("numpy-fast", "numpy-int", "fft-idct", "strict-fast")
LOADER_WORKERS = (0, 2)


def main(argv: Optional[Sequence[str]] = None, *, corpus_n: int = 32,
         st_repeats: int = 2, loader_repeats: int = 1) -> Dict[str, Any]:
    """Run the quickstart; returns what it printed. ``corpus_n`` and the
    repeats are the reference's defaults, smaller in tests."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_flag(ap)
    args = ap.parse_args(argv)
    with on_device(args.device):
        return _run(corpus_n, st_repeats, loader_repeats)


def _run(corpus_n: int, st_repeats: int,
         loader_repeats: int) -> Dict[str, Any]:
    # 1. a synthetic ImageNet-like corpus (incl. one rare Adobe-YCCK JPEG)
    corpus = build_corpus(corpus_n, seed=0)
    out: Dict[str, Any] = {"corpus": {"n": len(corpus.files),
                                      "rare_index": corpus.rare_index}}
    print(f"corpus: {len(corpus.files)} JPEGs, rare index "
          f"{corpus.rare_index}")

    # 2. decode one image through three engines, as decoder sessions
    out["decodes"] = {}
    for name in ENGINES:
        with open_decoder(name, context=ExecContext.INLINE) as dec:
            img = dec.decode(corpus.files[0]).unwrap()
            bucket = dec.probe(corpus.files[0])[:2]
            print(f"  {name:12s} -> {img.shape} {img.dtype} "
                  f"bucket={bucket}")
        out["decodes"][name] = {"shape": list(img.shape),
                                "dtype": str(img.dtype),
                                "bucket": list(bucket)}

    # 2b. a strict decoder *skips* the rare mode instead of erroring
    with open_decoder("strict-fast") as dec:
        res = dec.decode(corpus.files[corpus.rare_index])
        print(f"  strict-fast on rare image -> {res.kind}: {res.reason}")
    out["strict"] = {"kind": res.kind, "reason": res.reason}

    # 2c. eligibility is a (capabilities, context) question
    verdict = eligible(get_decoder("torch-fused").caps,
                       ExecContext.PROCESS_POOL)
    print(f"  torch-fused in a forked pool? {bool(verdict)} "
          f"({verdict.reason})")
    out["eligible"] = {"decoder": "torch-fused", "ok": bool(verdict),
                       "reason": verdict.reason}

    # 3. the two protocols (run_path takes registered decoder names)
    records = SingleThreadProtocol(corpus, repeats=st_repeats).run(
        list(PROTOCOL_PATHS))
    loader = LoaderProtocol(corpus, repeats=loader_repeats)
    for n in PROTOCOL_PATHS:
        for w in LOADER_WORKERS:
            records.append(loader.run_path(n, w))
    out["records"] = [r.to_json() for r in records]

    print("\nsingle-thread img/s:")
    out["single_thread"] = {}
    for r in records:
        if r.protocol == "single_thread":
            print(f"  {r.decoder:12s} {r.throughput_mean:7.1f} "
                  f"skips={r.skips}")
            out["single_thread"][r.decoder] = {
                "img_s": r.throughput_mean, "skips": r.skips}

    # 4. the decision protocol (zero-skip tier, protocol disagreement)
    rec = decision.recommend(records)
    d = rec["protocol_disagreement"]["live-host"]
    print(f"\nsingle-thread leader: {d['single_leader']}")
    print(f"loader leader:        {d['loader_leader']}")
    print(f"rank correlation:     rho={d['rho']:.2f}")
    print("zero-skip tier:       "
          + ", ".join(t.decoder for t in rec["tier"]))
    out["disagreement"] = d
    out["tier"] = [t.decoder for t in rec["tier"]]
    return out


if __name__ == "__main__":
    main()
