"""Where the beam engine's time goes on the card.

    python -m pgvector_rx_tpu_torch.probes.beam_profile

Needs one NVIDIA GPU and ``nvcc``. Builds the smoke's 1,000,000 x 128-d
index (``make_dataset`` seed 0, m=16, ef_construction=64, serving-only,
from a CUDA tensor) and serves its 16,384 queries with
``serve_topk(engine="beam", ef=40)`` in chunks of 1,024, then prints:

- the wall time of ``serve_topk`` (host clock after a synchronize), three
  runs after a warm one;
- the device time of the two parts of one 1,024-query chunk (CUDA events,
  mean of 20 runs): the coarse seeding (``_coarse_seeds``: the bf16 sweep
  over the level >= 1 rows, its top-8 and the exact seed distances) and
  the walk (kernel K4);
- ``torch.profiler`` over one ``serve_topk``: device time by kernel name
  (the top 12), kernel launches, and the busy share (kernel time over the
  wall time of the profiled call).
"""

from __future__ import annotations

import time

import torch

from pgvector_rx_tpu_torch import HnswIndex, IndexParams
from pgvector_rx_tpu_torch.data import make_dataset
from pgvector_rx_tpu_torch.graph import device as device_mod
from pgvector_rx_tpu_torch.ops import beam

N, D, NQ, K, EF, CHUNK = 1_000_000, 128, 16_384, 10, 40, 1024


def _event_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    dev = torch.device("cuda:0")
    data, queries = make_dataset(N, D, NQ, seed=0)
    index = HnswIndex.build(torch.from_numpy(data).to(dev), metric="l2",
                            params=IndexParams(m=16, ef_construction=64),
                            host_graph=False, device=dev, seed=1)
    q = torch.from_numpy(queries).to(dev)
    g = index.device_graph()

    def serve():
        device_mod.serve_topk(index, q, K, engine="beam", ef=EF)

    serve()
    for run in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        serve()
        torch.cuda.synchronize()
        dt = time.time() - t0
        print(f"serve_topk beam run {run}: {dt * 1e3:.3f} ms wall, "
              f"{NQ / dt:.1f} qps")

    q1 = q[:CHUNK].contiguous()
    upper = device_mod._coarse_upper(g)
    ids, sd = device_mod._coarse_seeds(g, q1, upper[0], upper[1], 8)
    seed_ms = _event_ms(
        lambda: device_mod._coarse_seeds(g, q1, upper[0], upper[1], 8))
    walk_ms = _event_ms(lambda: beam.beam_walk(
        g.values, g.neighbors0, g.traversable, "l2", q1, ids, sd, EF,
        4 * EF + 32))
    print(f"one {CHUNK}-query chunk: coarse seeding {seed_ms:.4f} ms, "
          f"walk (K4) {walk_ms:.4f} ms, upper rows {upper[1].shape[0]}")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        serve()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    launches = sum(e.count for e in kern)
    print(f"profiled serve_topk: {wall_ms:.3f} ms wall, {busy_ms:.3f} ms of "
          f"kernels in {launches} launches, busy share "
          f"{busy_ms / wall_ms:.4f}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} x "
              f"{e.key[:90]}")


if __name__ == "__main__":
    main()
