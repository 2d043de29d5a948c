"""K15's form choice, K19's work plan and K15's plain version, on the CPU.

- ``bwd_form`` (``kernels/attention.py``) picks K15's one-launch cluster
  form or its two-pass form by shape; the table below is the one PERF.md
  states (the cluster form up to 512 keys and head dim 64).
- ``work_plan`` (``kernels/adam.py``) cuts K19's parameters into spans:
  each element in exactly one span, every vector span 16-byte aligned in
  p, m and v and a multiple of 4 values, scalar spans for a head, a tail
  or a tensor whose p, m and v are not aligned alike.  An emulation of the
  kernel over the plan (each span's elements through the plain version's
  arithmetic) gives the plain version's bits: every element updated once.
- ``attention_bwd_plain`` against ``jax.vjp`` of the JAX package's
  attention (``pathway_tpu.ops.ring_attention.local_attention``, the math
  of ``SelfAttention.__call__``) at 512 keys and head dims 80 and 128, with
  a batch row of no present key, within 1e-5 of each gradient's max|ref|
  (f32 sums over 512 keys in another order).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke
from pathway_tpu.ops.ring_attention import local_attention
from pathway_tpu_torch.kernels.adam import MAX_TENSORS, UNIT, adam_step, adam_step_plain, work_plan
from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels.attention import (
    BWD_CLUSTER_MAX_HEAD_DIM,
    BWD_CLUSTER_MAX_LEN,
    MAX_LEN,
    attention_bwd_plain,
    attention_plain,
    bwd_form,
    check_attention,
)

BWD_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The small products run faster on one thread, and leave the other
    cores to the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# K15's form by shape (PERF.md §6, "K15's forms")

#: (L, head dim) -> form
FORMS = {
    (chip_smoke.TRAIN_L, 64): "cluster",  # the train step's [64, 128, 12, 64]
    (16, 16): "cluster",  # K15_CASES: the dry run's shard
    (64, 32): "cluster",
    (200, 24): "cluster",  # 2 blocks of 128 keys, D zero-padded to 32
    (448, 40): "cluster",  # 4 blocks, D zero-padded to 64
    (512, 80): "two_pass",  # zero-padded to 128
    (512, 128): "two_pass",
    (512, 64): "cluster",  # 8 key tiles: the largest cluster
    (513, 64): "two_pass",
    (524_288, 64): "two_pass",
    (128, 8): "cluster",
    (128, 128): "two_pass",
    (128, 72): "two_pass",
    (1, 8): "cluster",
}


@pytest.mark.parametrize("shape", sorted(FORMS), ids=lambda s: f"L{s[0]}-D{s[1]}")
def test_bwd_form_by_shape(shape):
    assert bwd_form(*shape) == FORMS[shape]


def test_every_k15_case_of_the_chip_script_has_its_form():
    cases = [(chip_smoke.TRAIN_L, 64)] + [(L, D) for _, L, _, D in chip_smoke.K15_CASES]
    assert [bwd_form(L, D) for L, D in cases] == ["cluster"] * 6 + ["two_pass"] * 2


def test_k15_limits_reach_the_kernel_build_as_flags():
    """The cluster form's limits have one owner: the build passes
    ``attention.py``'s constants to ``csrc/attention_bwd.cu`` as ``-D``
    flags (read from the wrapper's source, not imported), and they enter the
    library's build name."""
    assert _build._defines("attention_bwd") == [
        f"-DPW_BWD_CLUSTER_MAX_LEN={BWD_CLUSTER_MAX_LEN}",
        f"-DPW_BWD_CLUSTER_MAX_HEAD_DIM={BWD_CLUSTER_MAX_HEAD_DIM}",
    ]
    assert _build._defines("adam") == []
    src = (_build._CSRC / "attention_bwd.cu").read_text()
    assert "PW_BWD_CLUSTER_MAX_LEN" in src and "PW_BWD_CLUSTER_MAX_HEAD_DIM" in src


@pytest.mark.parametrize("L", [513, 4096, MAX_LEN])
def test_check_attention_still_takes_the_two_pass_lengths(L):
    """K15's limits did not shrink with the cluster form: the longest
    sequences run its two-pass form."""
    q = torch.empty((1, L, 1, 8), dtype=torch.float32, device="meta")
    check_attention(q, q, q, torch.empty((1, L), dtype=torch.uint8, device="meta"))
    assert bwd_form(L, 8) == "two_pass"


# ---------------------------------------------------------------------------
# K19's work plan

SIZES = (1, 3, 4, 5, 65_535, 65_537, 2_359_296)


def _check_plan(tensors, plan):
    """Each element of each tensor in exactly one span; vector spans
    16-byte aligned in p, m and v, a multiple of 4 values, at most UNIT."""
    assert plan.dtype == np.int64 and plan.shape[1] == 3
    for i, (n, *addrs) in enumerate(tensors):
        rows = plan[plan[:, 0] == i]
        order = np.argsort(rows[:, 1], kind="stable")
        starts, counts = rows[order, 1], np.abs(rows[order, 2])
        assert (counts > 0).all() and (counts <= UNIT).all()
        ends = starts + counts
        assert starts[0] == 0 and ends[-1] == n and (starts[1:] == ends[:-1]).all()
        vec = rows[rows[:, 2] > 0]
        assert (vec[:, 2] % 4 == 0).all()
        for a in addrs:
            assert ((a + 4 * vec[:, 1]) % 16 == 0).all()
    return plan


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("offset", [0, 1, 2, 3], ids=lambda o: f"view+{o}")
def test_work_plan_covers_each_element_once(n, offset):
    """p, m and v views that start ``offset`` values into their storage
    (offset 0: 16-byte aligned): a scalar head up to the first aligned
    value, vector spans, a scalar tail."""
    bases = [torch.zeros(n + 4) for _ in range(3)]
    views = [b[offset:offset + n] for b in bases]
    tensors = [(n, *(t.data_ptr() for t in views))]
    plan = _check_plan(tensors, work_plan(tensors))
    head = min(n, (4 - offset) % 4) if bases[0].data_ptr() % 16 == 0 else None
    if head is not None:
        assert int((plan[:, 2] < 0).sum()) <= 2
        body = (n - head) // 4 * 4
        assert int(plan[plan[:, 2] > 0, 2].sum()) == body


def test_work_plan_takes_differently_aligned_tensors_scalar():
    """A 16-byte-misaligned view of p beside aligned m and v: scalar spans only."""
    n = 65_537
    p = torch.zeros(n + 1)[1:]
    m, v = torch.zeros(n), torch.zeros(n)
    tensors = [(n, p.data_ptr(), m.data_ptr(), v.data_ptr())]
    plan = _check_plan(tensors, work_plan(tensors))
    assert (plan[:, 2] < 0).all() and len(plan) == -(-n // UNIT)


def test_work_plan_over_a_parameter_set():
    """Every size at once, with a misaligned view among them: spans of
    every tensor, in tensor order, each covered once."""
    ts = [torch.zeros(n) for n in SIZES] + [torch.zeros(4099)[3:]]
    tensors = [(t.numel(), t.data_ptr(), t.data_ptr(), t.data_ptr()) for t in ts]
    plan = _check_plan(tensors, work_plan(tensors))
    assert (np.diff(plan[:, 0]) >= 0).all()
    assert set(plan[:, 0].tolist()) == set(range(len(ts)))
    assert work_plan([]).shape == (0, 3) and work_plan([(0, 0, 0, 0)]).shape == (0, 3)


def test_kernel_emulated_over_the_plan_gives_the_plain_bits():
    """Each span's elements through the plain version's f32 arithmetic, as
    the kernel takes them: the same bits as the plain version over whole
    tensors (an element missed or updated twice would differ)."""
    rng = np.random.default_rng(0)
    sizes = (1, 3, 5, 4099, 65_537)
    store = [torch.from_numpy(rng.standard_normal(n + 4).astype(np.float32)) for n in sizes]
    ps = [s[1:1 + n] for s, n in zip(store, sizes)]  # misaligned alike with m and v below
    gs = [torch.from_numpy(rng.standard_normal(n).astype(np.float32)) * 1e-3 for n in sizes]
    ms = [torch.zeros(n + 4)[1:1 + n] for n in sizes]
    vs = [torch.zeros(n + 4)[1:1 + n] for n in sizes]
    want = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    for step in (1, 2):
        adam_step_plain(want[0], gs, want[1], want[2], step, 1e-3)
    tensors = [(p.numel(), p.data_ptr(), m.data_ptr(), v.data_ptr()) for p, m, v in zip(ps, ms, vs)]
    plan = work_plan(tensors)
    assert (plan[:, 2] > 0).any() and (plan[:, 2] < 0).any()
    for step in (1, 2):
        for i, start, count in plan.tolist():
            sl = slice(start, start + abs(count))
            adam_step_plain([ps[i][sl]], [gs[i][sl]], [ms[i][sl]], [vs[i][sl]], step, 1e-3)
    for got, ref in zip(ps + ms + vs, want[0] + want[1] + want[2]):
        assert torch.equal(got, ref)


def test_adam_step_refuses_more_tensors_than_a_launch_takes():
    ts = [torch.empty(1, device="meta") for _ in range(MAX_TENSORS + 1)]
    with pytest.raises(ValueError, match=f"at most {MAX_TENSORS}"):
        adam_step(ts, ts, ts, ts, 1, 1e-4)
    with pytest.raises(ValueError, match="CUDA"):
        adam_step(ts[:MAX_TENSORS], ts[:MAX_TENSORS], ts[:MAX_TENSORS], ts[:MAX_TENSORS], 1, 1e-4)


def test_adam_step_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(1)
    p, g = (torch.from_numpy(rng.standard_normal(37).astype(np.float32)) for _ in range(2))
    m, v = torch.zeros(37), torch.zeros(37)
    ref = [t.clone() for t in (p, m, v)]
    adam_step([p], [g], [m], [v], 1, 1e-3)
    adam_step_plain([ref[0]], [g], [ref[1]], [ref[2]], 1, 1e-3)
    for a, b in zip((p, m, v), ref):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K15's plain version against jax.vjp of the JAX package's attention


@pytest.mark.parametrize("D", [80, 128])
def test_attention_bwd_plain_matches_jax_vjp_at_512_keys(D):
    B, L, H = 3, 512, 2
    rng = np.random.default_rng(D)
    q, k, v, dout = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(4))
    mask = (rng.random((B, L)) < 0.6).astype(np.uint8)
    mask[1] = 0  # no present key: the uniform average, and its gradient
    mask[2, :] = 0
    mask[2, 70:90] = 1  # present keys in the second 64-key tile only
    out, vjp = jax.vjp(lambda a, b, c: local_attention(a, b, c, jnp.asarray(mask)),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(t) for t in vjp(jnp.asarray(dout))]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    tmask = torch.from_numpy(mask)
    o, lse = attention_plain(tq, tk, tv, tmask, with_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=1e-5)
    got = attention_bwd_plain(tq, tk, tv, o, tdo, tmask, lse)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = float(np.abs(a.numpy() - b).max())
        assert err <= BWD_RTOL * float(np.abs(b).max()), (name, err)
    # a masked key's dk and dv are 0 where the row has a present key
    assert float(got[1][2, :70].abs().max()) == 0.0 and float(got[2][2, 90:].abs().max()) == 0.0
