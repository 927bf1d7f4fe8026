"""Collective micro-benchmark: psum / all_gather / ppermute over the mesh.

Validates the interconnect assumptions the learner's gradient all-reduce rides
on (SURVEY.md §5: the distributed backend is the JAX runtime itself — XLA
collectives, which XLA:GPU hands to NCCL). Runs on any mesh, including the
fake CPU mesh (mechanism test; bandwidth numbers only mean something on real
multi-card hardware).

    python -m gym_simpletetris_tpu.parallel.collective_bench --mb 64
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from .mesh import DATA_AXIS, make_data_mesh


def bench_collectives(mesh, mb: float = 64.0, iters: int = 10) -> dict:
    n = mesh.size
    per_dev = int(mb * 1e6 / 4)
    x = jnp.ones((n * per_dev,), jnp.float32)

    def run(name, fn, bytes_per_device):
        f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(DATA_AXIS),
                                  out_specs=P(DATA_AXIS), check_vma=False))
        out = f(x)
        np.asarray(out[:1])
        t0 = time.perf_counter()
        for _ in range(iters):
            out = f(out if out.shape == x.shape else x)
        np.asarray(out[:1])
        dt = (time.perf_counter() - t0) / iters
        return {"op": name, "seconds": round(dt, 6),
                "algo_GBps_per_device": round(bytes_per_device / dt / 1e9, 3)}

    shard_bytes = per_dev * 4
    res = [
        # ring all-reduce: reduce-scatter + all-gather = 2*(n-1)/n shards moved
        run("psum", lambda s: jax.lax.psum(s, DATA_AXIS) / n,
            shard_bytes * 2 * (n - 1) / n),
        # ring all-gather: each device sends/receives (n-1) shards
        run("all_gather_sum",
            lambda s: jax.lax.all_gather(s, DATA_AXIS).sum(axis=0),
            shard_bytes * (n - 1)),
        # ppermute: one shard per device
        run("ppermute", lambda s: jax.lax.ppermute(
            s, DATA_AXIS, [(i, (i + 1) % n) for i in range(n)]),
            shard_bytes),
    ]
    return {"devices": n, "mb_per_device": mb, "results": res}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mb", type=float, default=64.0)
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    mesh = make_data_mesh()
    out = bench_collectives(mesh, args.mb, args.iters)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
