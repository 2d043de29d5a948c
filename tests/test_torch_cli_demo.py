"""The port's CLI (``python -m pathway_tpu_torch.cli``), ``pw.demo``
streams and ``pw.viz`` against the JAX package's, on the CPU.

The CLI and demo cases of ``tests/test_cli_demo_behaviors.py`` (spawn's
``PATHWAY_*`` environment, an unknown command, the four demo streams), the
viz cases of ``tests/test_stdlib_misc.py`` (``LivePlot``'s SVG) and
``tests/test_temporal_windows_extra.py`` (``table_viz``'s HTML), each
written once as a function of the package module and run through both
packages; and ``lint``'s findings for one streaming program, which must be
the JAX CLI's line for line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the tier-1 run has several test workers on the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_graphs():
    """Reset both packages' global graphs around each test."""
    for pw in (jpw, tpw):
        pw.G.clear()
    yield
    for pw in (jpw, tpw):
        pw.G.clear()


def rows_of(pw, table) -> list[tuple]:
    (rows, _), = pw.debug._run_capture(table)
    return sorted((tuple(v) for v in rows.values()), key=repr)


def both(build) -> list:
    """``build(pw)`` -> a table, through each package: equal rows; the
    port's."""
    want = rows_of(jpw, build(jpw))
    got = rows_of(tpw, build(tpw))
    assert got == want
    return got


# ---------------------------------------------------------------------------
# CLI


def spawn_env(cli_main, tmp_path) -> list[dict]:
    out = tmp_path / cli_main.__module__
    out.mkdir()
    prog = tmp_path / f"p_{cli_main.__module__}.py"
    prog.write_text(textwrap.dedent(f"""
        import json, os
        pid = os.environ.get("PATHWAY_PROCESS_ID")
        with open({str(out)!r} + "/env_%s.json" % pid, "w") as f:
            json.dump({{"pid": pid, "procs": os.environ.get("PATHWAY_PROCESSES"),
                       "threads": os.environ.get("PATHWAY_THREADS"),
                       "port": os.environ.get("PATHWAY_FIRST_PORT")}}, f)
        """))
    assert cli_main(["spawn", "--processes", "2", "--threads", "3", sys.executable, str(prog)]) == 0
    return [json.loads(p.read_text()) for p in sorted(out.glob("env_*.json"))]


def test_cli_spawn_sets_env_contract(tmp_path):
    from pathway_tpu.cli import main as jax_main
    from pathway_tpu_torch.cli import main

    got = spawn_env(main, tmp_path)
    assert got == spawn_env(jax_main, tmp_path)
    assert {rec["pid"] for rec in got} == {"0", "1"}
    assert all(rec["procs"] == "2" and rec["threads"] == "3" for rec in got)
    assert len({rec["port"] for rec in got}) == 1  # a shared first port


def test_cli_spawn_from_env(tmp_path, monkeypatch):
    prog = tmp_path / "p.py"
    prog.write_text(f"import os\nopen({str(tmp_path)!r} + '/threads', 'w').write(os.environ['PATHWAY_THREADS'])\n")
    monkeypatch.setenv("PATHWAY_SPAWN_ARGS", f"--threads 5 {sys.executable} {prog}")
    from pathway_tpu_torch.cli import main

    assert main(["spawn-from-env"]) == 0
    assert (tmp_path / "threads").read_text() == "5"


def test_cli_rejects_unknown_command():
    from pathway_tpu_torch.cli import main

    with pytest.raises(SystemExit):
        main(["no-such-command"])


LINT_PROGRAM = """
import {pkg} as pw

t = pw.demo.range_stream(nb_rows=50, input_rate=1000)
u = t.select(v=t.value, w=pw.apply(lambda x: x * 2, t.value), unused=t.value + 1)
g = u.groupby(u.w).reduce(u.w, n=pw.reducers.count())
pw.io.subscribe(g, on_change=lambda key, row, time, is_addition: None)
"""


def lint_lines(lint, pkg: str, tmp_path, capsys) -> tuple[int, list[str]]:
    prog = tmp_path / f"stream_{pkg}.py"
    prog.write_text(LINT_PROGRAM.format(pkg=pkg))
    rc = lint(str(prog))
    out = capsys.readouterr()
    return rc, out.out.splitlines() + [out.err.replace(str(prog), "<program>").strip()]


def test_cli_lint_findings_equal_the_jax_cli(tmp_path, capsys):
    from pathway_tpu.cli import lint as jax_lint
    from pathway_tpu_torch.cli import lint

    want = lint_lines(jax_lint, "pathway_tpu", tmp_path, capsys)
    jpw.G.clear()
    got = lint_lines(lint, "pathway_tpu_torch", tmp_path, capsys)
    assert got == want
    rc, lines = got
    assert rc == 0 and lines[-1] == "<program>: 0 error(s), 4 warning(s)"
    assert [line.split(" ", 1)[0] for line in lines[:-1]] == ["PW-D001", "PW-D001", "PW-P001", "PW-S001"]


def test_cli_module_runs_without_jax(tmp_path):
    """``python -m pathway_tpu_torch.cli lint`` in a fresh process where
    importing jax or the JAX package fails."""
    prog = tmp_path / "stream.py"
    prog.write_text(LINT_PROGRAM.format(pkg="pathway_tpu_torch"))
    block = tmp_path / "block"
    block.mkdir()
    for name in ("jax", "pathway_tpu"):
        (block / f"{name}.py").write_text(f"raise ImportError('{name} is blocked')\n")
    env = dict(os.environ, PYTHONPATH=f"{block}{os.pathsep}{REPO}")
    out = subprocess.run([sys.executable, "-m", "pathway_tpu_torch.cli", "lint", str(prog), "--werror"],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 1, out.stderr[-2000:]  # warnings fail --werror
    assert f"{prog}: 0 error(s), 4 warning(s)" in out.stderr
    assert out.stdout.count("PW-") == 4


# ---------------------------------------------------------------------------
# demo streams


def test_demo_range_stream_values():
    got = both(lambda pw: pw.demo.range_stream(nb_rows=5, input_rate=1000))
    assert sorted(r[0] for r in got) == [0.0, 1.0, 2.0, 3.0, 4.0]


def test_demo_noisy_linear_stream_shape():
    got = both(lambda pw: pw.demo.noisy_linear_stream(nb_rows=6, input_rate=1000))
    assert len(got) == 6 and sorted(r[0] for r in got) == [0, 1, 2, 3, 4, 5]


def test_demo_replay_csv(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("a,b\n1,x\n2,y\n")

    def build(pw):
        class S(pw.Schema):
            a: int
            b: str

        return pw.demo.replay_csv(str(p), schema=S, input_rate=1000)

    assert both(build) == [(1, "x"), (2, "y")]


def test_demo_replay_csv_with_time(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("t,v\n0,a\n5,b\n10,c\n")

    def build(pw):
        return pw.demo.replay_csv_with_time(str(p), schema=pw.schema_from_types(t=int, v=str), time_column="t",
                                            unit="ms", speedup=10.0)

    assert sorted(both(build)) == [(0, "a"), (5, "b"), (10, "c")]


def test_demo_generate_custom_stream():
    got = both(lambda pw: pw.demo.generate_custom_stream(
        value_generators={"n": lambda i: i * 10}, schema=pw.schema_from_types(n=int), nb_rows=4,
        input_rate=1000))
    assert got == [(0,), (10,), (20,), (30,)]


# ---------------------------------------------------------------------------
# viz


XYZ = """
    x | y  | z
    1 | 10 | a
    2 | 40 | b
    3 | 25 | c
    """


def live_plot_svg(pw) -> tuple[str, str]:
    t = pw.debug.table_from_markdown(XYZ)
    view = pw.viz.plot(t, sorting_col="x")
    pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    return view.to_svg(), view._repr_html_()


def test_viz_live_plot_svg():
    want, got = live_plot_svg(jpw), live_plot_svg(tpw)
    assert got == want
    svg, html = got
    assert svg.startswith("<svg") and "polyline" in svg
    assert ">y<" in svg  # the numeric series, labelled
    assert html == svg


def table_viz_html(pw) -> tuple[str, str]:
    t = pw.debug.table_from_markdown("""
    a | b
    1 | x
    2 | y
    """)
    panel = pw.viz.table_viz(t)
    before = panel._repr_html_()
    pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    return before, panel._repr_html_()


def test_table_viz_renders_html():
    want, got = table_viz_html(jpw), table_viz_html(tpw)
    assert got[0] == want[0] and "<table>" in got[0]  # the header renders before the run
    # rows come in the order of their keys' updates: compare the cells as sets
    assert sorted(got[1].split("<tr>")) == sorted(want[1].split("<tr>"))
    assert "x" in got[1] and "y" in got[1]
