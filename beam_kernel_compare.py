"""Time the graph beam step's segments of given checkouts on one GPU.

    python3 beam_kernel_compare.py [--stamps] [--profile] DIR [DIR ...]

Each DIR is a checkout of this repository (for instance one unpacked with
``git archive`` into a directory that .gitignore lists); a DIR may repeat,
so that "old new new old" puts two versions side by side in one call.  For
each DIR in turn, in a process of its own that imports that checkout's
``cphnsw_tpu_torch``: the graph cell's index (the 1M x 128d store drawn on
the card from the Threefry recipe, seed 0, 256 clusters;
CPIndex(128, bits=1, engine="graph"), R = 32, E = 4) and its first 1,024
queries at k = 10; then the beam from the search's own seeded state, step
by step to the end, through the step's kernels (``search.beam._step``)
and, alongside, the plain torch step (``_plain_step``), whose final state
must equal the kernels' bit for bit.  Each kernel segment is timed with
CUDA events after a ``torch.cuda._sleep`` (so that the host has queued it
and the events time the device alone), as ``chip_smoke.py`` phase 8c
does, and so are the torch spans between them: `counter` (before the
pop), `exact_pop`, `exact_rerank`, `gamma_sums` (between the merge and
the gamma update) and `tail`; `step` is their sum, the whole step's
device time without the spins.  Prints one JSON line per checkout (ms per
step of each segment, the mean and the median over the steps; the steps;
the launch plan where the checkout names variants), then the card's name
and power limit as nvidia-smi gives them.

--profile adds, per checkout, a warm ``search_batch`` of the same queries
replayed from its kept CUDA graph as the graph cell runs it: the median
of 5 host-clock batches (ms), and one batch under torch.profiler: device
busy ms (the union of the kernels' intervals), device ops and busy ms per
beam step.

--stamps builds the checkout's kernels with -DBEAM_STAMPS (a measurement
build of csrc/beam_step.cu under build/, where the Hopper expansion and
merge stamp clock64() at each phase boundary) and adds, per kernel, the
mean cycles of each phase over the active blocks and the steps, a block's
mean wall time and the kernel's span (first block in to last block out,
%globaltimer), in ns.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

N, DIM, QUERIES, K = 1_000_000, 128, 1024, 10
SLEEP_CYCLES = 4_000_000        # ~2 ms at the H100's ~1.98 GHz
SEGMENTS = (("pop", "_pop"), ("expand", "_expand"), ("merge", "_merge"),
            ("gamma", "_gamma"))
# a step's spans between its marks (the spins lie outside every span)
SPANS = dict(counter=("begin", "pop<"), pop=("pop[", "pop]"),
             exact_pop=("pop>", "expand<"), expand=("expand[", "expand]"),
             exact_rerank=("expand>", "merge<"), merge=("merge[", "merge]"),
             gamma_sums=("merge>", "gamma<"), gamma=("gamma[", "gamma]"),
             tail=("gamma>", "end"))


def stamped_library(beam_step):
    """The -DBEAM_STAMPS build, put in place of the package's own, and a
    function that returns its stamps as a (2, blocks, slots) array after
    the next launches (clear first)."""
    import ctypes

    import numpy as np

    path, _ = beam_step.build_library(["-DBEAM_STAMPS"])
    lib = beam_step.load_library(path)
    lib.beam_stamps_copy.argtypes = [ctypes.c_void_p]
    beam_step.load_library = lambda path=None: lib
    buf = np.zeros((2, 4096, 10), dtype=np.int64)

    def read():
        if lib.beam_stamps_copy(buf.ctypes.data):
            raise RuntimeError("copying the stamps failed")
        return buf.copy()

    return lib.beam_stamps_clear, read


def phase_summary(stamps: list, kernel: int) -> dict:
    """Mean cycles between consecutive clock64 stamps of the blocks that
    stamped (slots 0-7), a block's mean wall ns (slot 9 - 8) and the
    kernel's mean span ns (last slot 9 - first slot 8), over the steps."""
    import numpy as np

    cycles, walls, spans = [], [], []
    for st in stamps:
        s = st[kernel]
        live = s[:, 0] != 0
        if not live.any():
            continue
        s = s[live]
        clk = s[:, :8].astype(np.float64)
        have = (clk != 0).all(axis=0)
        last = int(np.nonzero(have)[0].max())
        cycles.append(np.diff(clk[:, :last + 1], axis=1).mean(axis=0))
        walls.append(float((s[:, 9] - s[:, 8]).mean()))
        spans.append(float(s[:, 9].max() - s[:, 8].min()))
    n = min(len(c) for c in cycles)
    return dict(steps=len(cycles),
                cycles_per_phase=[float(x) for x in np.mean(
                    [c[:n] for c in cycles], axis=0)],
                block_wall_ns=float(np.mean(walls)),
                kernel_span_ns=float(np.mean(spans)))


def profiled_batch(g, q_dev) -> dict:
    """A warm search_batch of q_dev replayed from its kept CUDA graph: the
    median of 5 host-clock batches, then one batch under torch.profiler
    (device busy = the union of its kernels' intervals)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    queries = q_dev.cpu().numpy()
    for _ in range(2):
        g.search_batch(queries, k=K)
    torch.cuda.synchronize()
    wall = []
    for _ in range(5):
        t0 = time.perf_counter()
        g.search_batch(queries, k=K)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    steps = g._beam(q_dev, g._entry_candidates, K, g._max_steps(K),
                    debug_state=True)[2].steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        g.search_batch(queries, k=K)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return dict(p50_ms=statistics.median(wall), batch_ms=wall, steps=steps,
                busy_ms=busy / 1e3, device_ops=len(spans),
                device_ops_per_step=len(spans) / max(steps, 1),
                busy_ms_per_step=busy / 1e3 / max(steps, 1))


def worker(stamps: bool, profile: bool):
    sys.path.insert(0, os.getcwd())         # the checkout, not this file's
    import statistics

    import torch

    from cphnsw_tpu_torch import CPIndex
    from cphnsw_tpu_torch.kernels import beam_step
    from cphnsw_tpu_torch.search import beam
    from cphnsw_tpu_torch.utils.datasets import make_synthetic

    t0 = time.perf_counter()
    beam_step.build_library()
    if stamps:
        clear, read = stamped_library(beam_step)
    data = make_synthetic(f"synthetic-{N // 1000}k-{DIM}d",
                          n_queries=QUERIES, gt_k=K, n_clusters=256, seed=0,
                          gt_device="cuda", cache_dir=None)
    cp = CPIndex(DIM, bits=1, engine="graph", device="cuda")
    cp.build(data["base"])
    cp.finalize()
    g = cp._index
    q_dev = torch.from_numpy(data["queries"][:QUERIES]).cuda()

    def start():
        return beam._start(
            g._raw, g._norm_sq, g._neighbors, g._entry_candidates, g._signs,
            q_dev, g._params, g._bits, K, max(2 * g._r, 4 * K), 4,
            g._expand_width, 0, g._visited_hash_bits())

    marks: list[list] = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1].append((label, ev))

    stamped: list = []

    def timed(name, fn):
        def call(*args):
            mark(name + "<")
            if stamps and name == "expand":
                clear()
            torch.cuda._sleep(SLEEP_CYCLES)
            mark(name + "[")
            out = fn(*args)
            mark(name + "]")
            if stamps and name == "merge":
                torch.cuda.synchronize()
                stamped.append(read())
            torch.cuda._sleep(SLEEP_CYCLES)
            mark(name + ">")
            return out
        return call

    real = {fn: getattr(beam, fn) for _, fn in SEGMENTS}
    (sk, ck), (sp, cp_) = start(), start()
    max_steps = g._max_steps(K)
    try:
        for name, fn in SEGMENTS:
            setattr(beam, fn, timed(name, real[fn]))
        for step in range(max_steps):
            marks.append([])
            torch.cuda._sleep(SLEEP_CYCLES)
            mark("begin")
            sk = beam._step(sk, ck)
            mark("end")
            sp = beam._plain_step(sp, cp_)     # its own segments, untimed
            if bool(sk.done.all()) and bool(sp.done.all()):
                break
    finally:
        for fn, f in real.items():
            setattr(beam, fn, f)
    torch.cuda.synchronize()
    equal = all(
        torch.equal(*((x.view(torch.int32), y.view(torch.int32))
                      if x.dtype == torch.float32 else (x, y)))
        for x, y in zip(sk, sp))
    per_step = []
    for m in marks:
        ev = dict(m)
        t = {seg: ev[a].elapsed_time(ev[b]) for seg, (a, b) in SPANS.items()}
        t["step"] = sum(t.values())
        per_step.append(t)
    plan = beam_step.launch_plan(QUERIES, max(2 * g._r, 4 * K), K,
                                 g._expand_width, g._r,
                                 g._expand_width * g._r, g._padded, g._bits,
                                 g._neighbors.words)
    print(json.dumps(dict(
        checkout=os.getcwd(), steps=len(per_step), equal_plain_step=equal,
        ms_per_step={name: statistics.fmean(t[name] for t in per_step)
                     for name in per_step[0]},
        median_ms_per_step={name: statistics.median(t[name]
                                                    for t in per_step)
                            for name in per_step[0]},
        batch=profiled_batch(g, q_dev) if profile else None,
        plan={kind: list(p) for kind, p in plan._asdict().items()},
        stamps={name: phase_summary(stamped, i)
                for i, name in enumerate(("beam_expand", "beam_merge"))}
        if stamps else None,
        seconds=time.perf_counter() - t0)), flush=True)
    if not equal:
        sys.exit(1)


def main(argv):
    flags = []
    while argv[:1] and argv[0] in ("--worker", "--stamps", "--profile"):
        flags.append(argv.pop(0))
    if "--worker" in flags:
        worker("--stamps" in flags, "--profile" in flags)
        return
    if not argv:
        sys.exit(__doc__)
    rc = 0
    for d in argv:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--worker", *flags], cwd=d)
        rc = rc or proc.returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sys.exit(rc)


if __name__ == "__main__":
    main(sys.argv[1:])
