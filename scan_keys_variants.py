"""Time builds of the scan_keys CUDA kernel against each other on one GPU.

    python3 scan_keys_variants.py [NAME=NVCC_FLAGS ...] [--out DIR]

Each NAME=FLAGS pair builds csrc/scan_keys.cu through
``scan_keys.build_library`` with the package's nvcc flags plus FLAGS (e.g.
preprocessor switches "-DX=1"; "base=" adds nothing), all builds in
parallel, into DIR (default build/scan_keys_variants, with each build's
ptxas report beside it).  Then every build runs the main path's shapes
(1M rows x P 128, Q 2048 and Q 100, bins 1024), one sharded-scan shard's
(252,928 rows, bins 6,656) and a P = 1024 store on the same random
operands, in two rounds (forward, then backward), with the keys held
against the plain version.  A shape whose group axis the wrapper splits
(Q 100) is timed split and with splits=1.  Times are CUDA-event means of
10 launches after 2 warm-ups.  Needs one GPU.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import sys
import time
from pathlib import Path

import torch

from cphnsw_tpu_torch.kernels import scan_keys as sk

SHAPES = {"main": (1_000_448, 128, 2048, 1024),
          "shard": (252_928, 128, 2048, 6656),
          "q100": (1_000_448, 128, 100, 1024),
          "p1024": (100_352, 1024, 2048, 1024)}


def build(variants: dict[str, list[str]], out: Path) -> dict[str, Path]:
    """Builds every variant at once (nvcc runs outside the GIL)."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        jobs = {name: pool.submit(sk.build_library, flags, out)
                for name, flags in variants.items()}
    built = {}
    for name, job in jobs.items():
        try:
            path, _ = job.result()
        except RuntimeError as exc:
            print(f"{name}: {exc}", flush=True)
            continue
        report = sk.build_log(path).read_text()
        spills = sorted({ln.strip() for ln in report.splitlines()
                         if "spill stores" in ln})
        serial = sum("C7515" in ln or "C7520" in ln
                     for ln in report.splitlines())
        print(f"{name}: {path.name} built after "
              f"{time.perf_counter() - t0:.1f} s; {spills}; "
              f"{serial} wgmma serialization notes", flush=True)
        built[name] = path
    return built


def operands(rows, p, q, seed=2):
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", generator=g)
    return [torch.randint(-128, 128, (rows, p), dtype=torch.int8, **kw),
            torch.randn((6, rows), **kw),
            torch.randint(-128, 128, (q, p), dtype=torch.int8, **kw),
            torch.randn(q, **kw), torch.randn((q, 5), **kw)]


def mean_ms(ops, bins, n=10, **kw):
    for _ in range(2):
        sk.fused_scan_keys(*ops, bins, **kw)
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(n):
        sk.fused_scan_keys(*ops, bins, **kw)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", default=["base="])
    ap.add_argument("--out", type=Path,
                    default=Path("build/scan_keys_variants"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    variants = {}
    for v in args.variants:
        name, _, flags = v.partition("=")
        variants[name] = flags.split()
    built = build(variants, args.out)
    print(torch.cuda.get_device_name(0), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    data = {}
    for key, (rows, p, q, bins) in SHAPES.items():
        ops = operands(rows, p, q)
        data[key] = (ops, bins, sk.scan_keys_reference(*ops, bins))
    order = list(built.items())
    for rnd, names in enumerate((order, order[::-1])):
        for name, path in names:
            cells = []
            for key, (ops, bins, want) in data.items():
                got = sk.fused_scan_keys(*ops, bins, library=path)
                equal = torch.equal(got, want)
                cells.append(f"{key} {mean_ms(ops, bins, library=path):.4f}"
                             f" ms equal={equal}")
                q, groups = ops[2].shape[0], ops[0].shape[0] // bins
                if sk.launch_plan(q, ops[0].shape[1], bins, groups, sms
                                  ).splits > 1:
                    ms = mean_ms(ops, bins, library=path, splits=1)
                    cells.append(f"{key}-unsplit {ms:.4f} ms")
            print(f"round {rnd} {name}: " + ", ".join(cells), flush=True)


if __name__ == "__main__":
    main()
