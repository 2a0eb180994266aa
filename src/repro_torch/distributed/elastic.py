"""Elastic scaling + fault-tolerance policy for pod/host loss.

At 1000+-node scale the failure model is: a pod (or slice) drops, the job
must resume on the surviving topology without waiting for repair. The
mechanism here composes three pieces that already exist in this framework:

  1. checkpoints are topology-free — `CheckpointManager` snapshots fully
     gathered host arrays, so a checkpoint written on an N-chip mesh
     restores onto any other mesh (re-jitting shards it per the new mesh's
     param specs);
  2. the data loader's shard_index/shard_count re-slices the input stream
     to the surviving hosts, and its checkpointed cursor keeps exactly-once
     delivery across the re-shard;
  3. `ElasticPolicy` decides the new mesh: drop the pod axis (or halve the
     data axis) while preserving the model axis, and rescales the batch or
     accumulates to keep the global batch constant.

`tests/test_elastic.py` simulates the full cycle on host devices: train on
a (2, D, M) two-pod mesh -> checkpoint -> "lose a pod" -> restore onto
(1, D, M) with doubled gradient accumulation -> training continues with the
same global batch and a loss curve that proceeds from the checkpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        return int(np.prod(self.shape))

    def axis(self, name: str) -> int:
        return self.shape[self.axes.index(name)]


@dataclasses.dataclass(frozen=True)
class ElasticDecision:
    mesh: MeshSpec
    microbatch_scale: int       # extra grad-accumulation factor
    loader_shard_count: int     # data-stream re-slicing
    note: str


def plan_after_failure(current: MeshSpec, *, lost_pods: int = 0,
                       lost_data_rows: int = 0,
                       keep_global_batch: bool = True) -> ElasticDecision:
    """Produce the surviving-topology mesh + compensation factors.

    Policy: model parallelism is preserved (weight shards must stay
    complete); capacity loss comes out of the pod axis first, then the data
    axis; the global batch is preserved by scaling gradient accumulation by
    the capacity-loss factor (keep_global_batch=True) or shrinking the
    batch otherwise.
    """
    shape = list(current.shape)
    axes = list(current.axes)
    lost_factor = 1
    if lost_pods and "pod" in axes:
        i = axes.index("pod")
        if shape[i] - lost_pods < 1:
            raise ValueError("cannot lose every pod")
        lost_factor *= shape[i] // (shape[i] - lost_pods)
        shape[i] -= lost_pods
        if shape[i] == 1:
            del shape[i], axes[i]
    if lost_data_rows:
        i = axes.index("data")
        remaining = shape[i] - lost_data_rows
        if remaining < 1:
            raise ValueError("cannot lose the whole data axis")
        # keep a power-of-two-friendly data axis: round down
        new = 1
        while new * 2 <= remaining:
            new *= 2
        lost_factor *= shape[i] // new
        shape[i] = new
    mesh = MeshSpec(tuple(shape), tuple(axes))
    micro = lost_factor if keep_global_batch else 1
    return ElasticDecision(
        mesh=mesh,
        microbatch_scale=micro,
        loader_shard_count=mesh.num_devices // mesh.axis("model"),
        note=(f"capacity x1/{lost_factor}; grad-accum x{micro} keeps the "
              f"global batch" if keep_global_batch else
              f"capacity x1/{lost_factor}; global batch shrinks"),
    )
