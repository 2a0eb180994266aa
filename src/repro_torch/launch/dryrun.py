"""Dry-run CLI: count every (arch x shape) cell on ``meta`` tensors, for
one rank of the pod mesh (one card) and of the multi-pod mesh (2 x 16 x
16), and write the roofline artifacts.

Port of the reference's ``launch/dryrun.py``. It needs no card and no
placeholder devices (the port counts on ``meta`` tensors, see
``dryrun_lib``), so there is no ``XLA_FLAGS`` line.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod-only
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape prefill_32k --ctx '{"fused_scopes": ["vmem_flash"]}' --tag flash

Records go to ``artifacts/dryrun_torch/{arch}__{shape}__{pod|multipod}[-tag].json``
(``--out`` moves them), which ``python -m repro_torch.bench tables
--only roofline`` reads. It prints a summary line and exits 1 if any
cell is an error; then a line for each mesh counted (``pod:`` and
``multipod:``).
"""
import argparse
import json
import sys


def main(argv=None) -> int:
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun_lib import all_archs, run_matrix, \
        split_overrides

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None,
                    help="architecture id (repeatable); default: all")
    ap.add_argument("--shape", action="append", default=None,
                    help="shape name (repeatable); default: all")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--remat", default="full", choices=["full", "none"])
    ap.add_argument("--tag", default="", help="artifact tag for perf variants")
    ap.add_argument("--ctx", default="{}",
                    help="JSON ModelContext overrides for perf variants "
                         "(and the pseudo-keys fused_scopes, microbatch)")
    ap.add_argument("--unroll", action="store_true",
                    help="count every layer instead of depth by repeat")
    args = ap.parse_args(argv)

    archs = args.arch or all_archs()
    shapes = args.shape or list(SHAPES)
    overrides = dict(json.loads(args.ctx), remat=args.remat)
    try:
        split_overrides(overrides)
    except ValueError as e:          # a reference-only or unknown --ctx key
        ap.error(str(e))

    results = []
    if not args.multi_pod_only:
        results += run_matrix(archs, shapes, multi_pod=False,
                              out_dir=args.out, force=args.force,
                              ctx_overrides=overrides, tag=args.tag,
                              unroll=args.unroll)
    if not args.single_pod_only:
        results += run_matrix(archs, shapes, multi_pod=True,
                              out_dir=args.out, force=args.force,
                              ctx_overrides=overrides, tag=args.tag,
                              unroll=args.unroll)

    bad = [r for r in results if r["status"] == "error"]
    ok = [r for r in results if r["status"] == "ok"]
    skipped = [r for r in results if r["status"] == "skipped"]
    print(f"\ndry-run: {len(ok)} ok, {len(skipped)} skipped, "
          f"{len(bad)} errors")
    for mesh in ("pod", "multipod"):
        mine = [r for r in results
                if r["mesh_name"].split("-", 1)[0] == mesh]
        if mine:
            n = {k: sum(r["status"] == k for r in mine)
                 for k in ("ok", "skipped", "error")}
            print(f"  {mesh}: {n['ok']} ok, {n['skipped']} skipped, "
                  f"{n['error']} errors")
    for r in bad:
        print(f"  ERROR {r['arch']} x {r['shape']}: {r['error'][:160]}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
