"""The port's interactive mode (``pathway_tpu_torch/internals/
interactive.py``: ``export_table``, ``import_table``, ``LiveTable``,
``live``, ``enable_interactive_mode``) against the JAX package's, on the
CPU.

The three cases of ``tests/test_interactive.py`` are written once, as
functions of the package module, and run through both packages with the
same inputs: what each returns (snapshots, offsets, the update history,
the rows a second graph computes from an imported table) is equal, and
the JAX test's own assertions hold on the port's.
"""

from __future__ import annotations

import threading

import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw

AB = """
    a | b
    1 | x
    2 | y
    3 | z
    """


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


def export_snapshot_and_offsets(pw) -> dict:
    t = pw.debug.table_from_markdown(AB)
    exp = pw.export_table(t.select(t.a, t.b))
    pw.run()
    batch, off, frontier, closed = exp.data_from_offset(0)
    batch2, off2, _, _ = exp.data_from_offset(off)
    return {
        "closed": exp.closed,
        "snapshot": sorted(exp.snapshot().values()),
        "batch": sorted((v, d) for _t, _k, v, d in batch),
        "offset": off,
        "closed_at_read": closed,
        "tail": (batch2, off2),
        "columns": exp.column_names,
    }


def test_export_snapshot_and_offsets():
    want, got = export_snapshot_and_offsets(jpw), export_snapshot_and_offsets(tpw)
    assert got == want
    assert got["closed"] and got["closed_at_read"]
    assert got["snapshot"] == [(1, "x"), (2, "y"), (3, "z")]
    assert got["offset"] == 3 and all(d == 1 for _v, d in got["batch"])
    assert got["tail"] == ([], got["offset"])  # an incremental read from the end is empty


def import_into_second_graph(pw) -> dict:
    t = pw.debug.table_from_markdown(AB)
    exp = pw.export_table(t.select(t.a, t.b))
    pw.run()
    first_keys = set(exp.snapshot().keys())
    # a brand-new graph continues from the exported stream
    pw.G.clear()
    imported = pw.import_table(exp)
    filtered = imported.filter(imported.a >= 2).select(imported.a, imported.b)
    (rows, _), = pw.debug._run_capture(filtered)
    return {
        "dtype": imported._dtypes["a"].name,
        "rows": sorted(rows.values()),
        "keys_kept": set(rows.keys()) <= first_keys,
    }


def test_import_into_second_graph_preserves_keys_and_dtypes():
    want, got = import_into_second_graph(jpw), import_into_second_graph(tpw)
    assert got == want
    assert got == {"dtype": "INT", "rows": [(2, "y"), (3, "z")], "keys_kept": True}


def live_table_streams_and_waits(pw) -> dict:
    pw.enable_interactive_mode()
    t = pw.debug.table_from_markdown(
        """
        w | v | __time__ | __diff__
        x | 1 | 2        | 1
        y | 2 | 4        | 1
        x | 1 | 6        | -1
        """
    )
    lt = pw.LiveTable(t.select(t.w, t.v))
    th = threading.Thread(target=pw.run, daemon=True)
    th.start()
    th.join(30)
    df = lt.to_pandas()
    return {
        "finished": not th.is_alive(),
        "closed": lt.wait_closed(10),
        "snapshot": sorted(lt.snapshot().values()),
        "history": [(v, d) for _t, _k, v, d in lt.update_history()],
        "len": len(lt),
        "frame": (list(df.columns), len(df)),
    }


def test_live_table_streams_and_waits():
    want, got = live_table_streams_and_waits(jpw), live_table_streams_and_waits(tpw)
    assert got == want
    assert got["finished"] and got["closed"]
    assert got["snapshot"] == [("y", 2)]
    assert got["history"] == [(("x", 1), 1), (("y", 2), 1), (("x", 1), -1)]
    assert got["len"] == 1 and got["frame"] == (["w", "v"], 1)
