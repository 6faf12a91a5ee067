"""CLI entry point: ``python -m cphnsw_tpu_torch --config <yaml>``.

PyTorch counterpart of ``cphnsw_tpu/__main__.py`` with the same JSON-lines
events: one ``benchmark_start`` line per dataset and one ``summary`` line
per (dataset, algorithm) with build_time_min / memory_gib / recall_at_10 /
qps.  ``--bits``, ``--engine`` and ``--profile-dir`` (a torch.profiler
trace) are kept; ``--device`` (default ``cuda``) names the device, which
never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def read_config(path: Path) -> dict:
    """Parse the benchmark YAML; degrades to a tiny two-level parser when
    PyYAML is unavailable (the config grammar is section/key/scalar)."""
    text = path.read_text()
    try:
        import yaml
    except ImportError:
        return _parse_two_level(text)
    return yaml.safe_load(text)


def _parse_two_level(text: str) -> dict:
    root: dict = {}
    current: dict | None = None
    for raw in text.splitlines():
        stripped = raw.split("#", 1)[0].rstrip()
        if not stripped.strip():
            continue
        indented = stripped[0] in " \t"
        key, _, value = stripped.strip().partition(":")
        value = value.strip()
        if not indented:
            current = root.setdefault(key, {})
        elif current is not None:
            try:
                current[key] = int(value)
            except ValueError:
                current[key] = value
    return root


def emit(event: str, **fields) -> None:
    print(json.dumps({"event": event, **fields}), flush=True)


def main(argv=None) -> int:
    from cphnsw_tpu_torch.utils import datasets as ds_mod
    from cphnsw_tpu_torch.utils.eval import run_benchmark

    ap = argparse.ArgumentParser(
        prog="cphnsw_tpu_torch",
        description="CP-HNSW (PyTorch) benchmark runner (JSON-lines events).",
    )
    ap.add_argument("--config", type=Path, required=True)
    ap.add_argument("--bits", type=int, nargs="*", default=None,
                    help="restrict bit widths (default: 1 2 4)")
    ap.add_argument("--profile-dir", type=Path, default=None,
                    help="write a torch.profiler trace of one extra pass")
    ap.add_argument("--engine", choices=("auto", "scan", "graph"),
                    default="auto",
                    help="force the search engine (default: derived)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to build and search on "
                         "(default: cuda)")
    opts = ap.parse_args(argv)

    cfg = read_config(opts.config)
    wanted = cfg["data"]["dataset"]
    if wanted == "all":
        names = ds_mod.ALL_DATASETS
    elif isinstance(wanted, list):
        names = list(wanted)
    elif isinstance(wanted, str) and "," in wanted:
        # the YAML-less fallback parser leaves "[a, b]" as one string
        names = [t.strip() for t in wanted.strip("[]").split(",")
                 if t.strip()]
    else:
        names = [wanted]

    for name in names:
        emit("benchmark_start", dataset=name)
        report = run_benchmark(
            name,
            base_dir=Path(cfg["data"]["base_dir"]),
            k=cfg["eval"]["k"],
            n_runs=cfg["eval"]["n_runs"],
            output_dir=Path(cfg["run"]["output_dir"]),
            bit_widths=opts.bits,
            profile_dir=opts.profile_dir,
            engine=opts.engine,
            device=opts.device,
        )
        for case in report["results"]:
            emit(
                "summary",
                dataset=name,
                algorithm=case["algorithm"],
                build_time_min=round(case["build_time_s"] / 60.0, 4),
                memory_gib=round(case["memory_mb"] / 1024.0, 4),
                recall_at_10=case["recall_at_10"],
                qps=case["qps"],
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
