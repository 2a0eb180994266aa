#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives a gloo world accepts for CUDA
tensors, with every rank on one card.

    PYTHONPATH=src python3 tools/probe_gloo_cuda.py [--ranks 2]

NCCL refuses two ranks on one device, so a run of several ranks on one
card goes over gloo. The probe spawns ``--ranks`` processes, joins them
in a gloo world on a ``FileStore`` (no socket), all on ``cuda:0``, and
tries each collective the port's tensor-parallel and expert-parallel
paths could use, on the default group and on the model axis of a ``1 x
ranks`` device mesh (``launch.mesh.make_host_mesh(backend="gloo")``):
every call is checked against the value it must give. Prints the
versions, the card's name and power limit, and one JSON line a rank:
``{collective: "ok" | "wrong" | "<exception>"}``. Needs one NVIDIA card.
"""
import argparse
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANK = r"""
import json, sys
import torch, torch.distributed as dist
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch.device import set_device
from repro_torch.launch.mesh import make_host_mesh
set_device("cuda")
dev = torch.device("cuda", 0)
out = {}


def attempt(name, fn):
    try:
        out[name] = "ok" if fn() else "wrong"
    except Exception as e:  # noqa: BLE001 - the probe reports each refusal
        out[name] = f"{type(e).__name__}: {str(e)[:160]}"
    torch.cuda.synchronize()


def groups():
    yield "world", None
    try:
        mesh = make_host_mesh(1, world, backend="gloo")
        yield "mesh", mesh.get_group("model")
    except Exception as e:  # noqa: BLE001
        out["make_host_mesh"] = f"{type(e).__name__}: {str(e)[:160]}"


for tag, g in groups():
    n = world
    x = torch.full((4, 6), float(rank + 1), device=dev)
    total = float(sum(range(1, n + 1)))

    def all_reduce():
        t = x.clone()
        dist.all_reduce(t, group=g)
        return bool((t == total).all())

    def all_reduce_max():
        t = x.clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
        return bool((t == n).all())

    def all_gather_into_tensor():
        t = torch.empty((4 * n, 6), device=dev)
        dist.all_gather_into_tensor(t, x, group=g)
        return all(bool((t[4 * r:4 * r + 4] == r + 1).all())
                   for r in range(n))

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=g)
        return all(bool((p == r + 1).all()) for r, p in enumerate(parts))

    def reduce_scatter_tensor():
        t = torch.empty((4, 6), device=dev)
        dist.reduce_scatter_tensor(t, x.repeat(n, 1), group=g)
        return bool((t == total).all())

    def reduce_scatter():
        t = torch.empty((4, 6), device=dev)
        dist.reduce_scatter(t, [x.clone() for _ in range(n)], group=g)
        return bool((t == total).all())

    def all_to_all_single():
        t = torch.empty((4 * n, 6), device=dev)
        dist.all_to_all_single(t, x.repeat(n, 1), group=g)
        return all(bool((t[4 * r:4 * r + 4] == r + 1).all())
                   for r in range(n))

    def broadcast():
        t = x.clone()
        dist.broadcast(t, src=0, group=g)
        return bool((t == 1).all())

    for fn in (all_reduce, all_reduce_max, all_gather_into_tensor,
               all_gather, reduce_scatter_tensor, reduce_scatter,
               all_to_all_single, broadcast):
        attempt(f"{tag}.{fn.__name__}", fn)
print(json.dumps({"rank": rank, **out}))
dist.destroy_process_group()
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_gloo_cuda: no CUDA card visible", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK, str(r), str(args.ranks), store],
            env=env, cwd=ROOT) for r in range(args.ranks)]
        try:
            rcs = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
