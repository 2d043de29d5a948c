"""``pathway_tpu_torch`` CLI (reference ``python/pathway/cli.py:53-319``):
``spawn`` runs a program under N processes x M threads;
``spawn-from-env`` reads the command from PATHWAY_SPAWN_ARGS.

Process topology env contract matches the reference
(``src/engine/dataflow/config.rs:86-120``): PATHWAY_THREADS,
PATHWAY_PROCESSES, PATHWAY_PROCESS_ID, PATHWAY_FIRST_PORT.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

__all__ = ["main", "spawn", "lint"]


def spawn(
    threads: int,
    processes: int,
    first_port: int,
    program: str,
    arguments: list[str],
    record: bool = False,
    record_path: str | None = None,
) -> int:
    env_base = dict(os.environ)
    env_base["PATHWAY_THREADS"] = str(threads)
    env_base["PATHWAY_PROCESSES"] = str(processes)
    env_base["PATHWAY_FIRST_PORT"] = str(first_port)
    if record:
        env_base["PATHWAY_PERSISTENT_STORAGE"] = record_path or "./record"
        env_base["PATHWAY_PERSISTENCE_MODE"] = "persisting"
    if processes <= 1:
        env_base["PATHWAY_PROCESS_ID"] = "0"
        return subprocess.call([program, *arguments], env=env_base)
    procs = []
    for pid in range(processes):
        env = dict(env_base)
        env["PATHWAY_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen([program, *arguments], env=env))
    code = 0
    for p in procs:
        code = p.wait() or code
    return code


def lint(
    program: str,
    *,
    werror: bool = False,
    plan: bool = False,
    memory: bool = False,
    device: bool = False,
    baseline: str | None = None,
) -> int:
    """Build ``program``'s dataflow graph without running it and print
    the pre-flight analyzer's findings (``pathway_tpu_torch/analysis/``).
    With ``plan=True`` also print the optimizer's execution plan for the
    built graph (``pw.explain()`` textual form, at the PATHWAY_OPTIMIZE
    level); with ``memory=True`` also print the plan-aware capacity
    report (``pw.estimate_memory()``; scenario and budget come from the
    PATHWAY_MEMORY_* environment — a blown PATHWAY_MEMORY_BUDGET
    surfaces as a PW-M002 finding above, not a separate exit path);
    with ``device=True`` additionally sweep the program file AND the
    port's whole device surface (``device_module_files()``: ``kernels/``,
    ``parallel/``, ``ops/``, ``serving/``, ...) through the PW-J
    device-safety analyzer, whether or not the built graph reaches it.
    ``baseline`` names a JSON file mapping program basenames to
    ACCEPTED warning codes: baselined warnings are still printed but do
    not fail ``--werror`` (errors are never baselined — an accepted
    hazard belongs in the config, not silenced in code).  Exit 1 on
    error-severity diagnostics (or any unbaselined finding with
    ``--werror``), 0 on a clean graph."""
    import json
    import os.path

    from pathway_tpu_torch.analysis import SEV_ERROR, format_diagnostics, lint_file

    accepted: set[str] = set()
    if baseline is not None:
        with open(baseline, encoding="utf-8") as fh:
            table = json.load(fh)
        accepted = set(table.get(os.path.basename(program), ()))

    diags = lint_file(program)
    if device:
        # file-level sweep: program source + the repo device modules,
        # deduplicated against findings the graph pass already raised
        from pathway_tpu_torch.analysis import scan_device, device_module_files

        seen = {(d.code, d.trace) for d in diags}
        report = scan_device([program, *device_module_files()])
        diags = list(diags) + [
            d for d in report.diagnostics if (d.code, d.trace) not in seen
        ]
    if diags:
        print(format_diagnostics(diags))
    if plan:
        # lint_file leaves the built graph in place; compile its plan
        from pathway_tpu_torch.analysis import explain

        print(explain().format())
    if memory:
        # same built graph: the plan-aware capacity report
        from pathway_tpu_torch.analysis import estimate_memory

        print(estimate_memory().format())
    errors = sum(1 for d in diags if d.severity == SEV_ERROR)
    warnings = len(diags) - errors
    gating = [
        d for d in diags if d.severity == SEV_ERROR or d.code not in accepted
    ]
    baselined = len(diags) - len(gating)
    suffix = f", {baselined} baselined" if baselined else ""
    print(
        f"{program}: {errors} error(s), {warnings} warning(s){suffix}",
        file=sys.stderr,
    )
    if errors or (werror and gating):
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="pathway_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("spawn", help="run a pipeline with worker topology")
    sp.add_argument("--threads", "-t", type=int, default=1)
    sp.add_argument("--processes", "-n", type=int, default=1)
    sp.add_argument("--first-port", type=int, default=10000)
    sp.add_argument("--record", action="store_true")
    sp.add_argument("--record-path", default=None)
    sp.add_argument("program")
    sp.add_argument("arguments", nargs=argparse.REMAINDER)

    se = sub.add_parser("spawn-from-env", help="spawn using $PATHWAY_SPAWN_ARGS")

    lp = sub.add_parser(
        "lint",
        help="statically analyze a pipeline's graph without running it",
    )
    lp.add_argument("program", help="Python file that builds the graph")
    lp.add_argument(
        "--werror",
        action="store_true",
        help="exit non-zero on warnings too",
    )
    lp.add_argument(
        "--plan",
        action="store_true",
        help="also print the optimizer's execution plan",
    )
    lp.add_argument(
        "--memory",
        action="store_true",
        help="also print the plan-aware memory capacity report",
    )
    lp.add_argument(
        "--device",
        action="store_true",
        help="also sweep the program and the repo device modules "
        "through the PW-J device-safety analyzer",
    )
    lp.add_argument(
        "--baseline",
        default=None,
        help="JSON file of accepted warning codes per program basename",
    )

    args = parser.parse_args(argv)
    if args.command == "spawn":
        return spawn(
            args.threads,
            args.processes,
            args.first_port,
            args.program,
            args.arguments,
            record=args.record,
            record_path=args.record_path,
        )
    if args.command == "spawn-from-env":
        spawn_args = os.environ.get("PATHWAY_SPAWN_ARGS", "").split()
        return main(["spawn", *spawn_args])
    if args.command == "lint":
        return lint(
            args.program,
            werror=args.werror,
            plan=args.plan,
            memory=args.memory,
            device=args.device,
            baseline=args.baseline,
        )
    return 2


if __name__ == "__main__":
    sys.exit(main())
