"""K17's and K9's plans, emulated in torch on the CPU.

- ``bwd_plan`` (``kernels/embed_ln.py``) cuts K17's embedding form into
  items, the rows of one position (or of a share of the batch at it): each
  row in exactly one item, no item empty, none over ``ITEM_ROWS``.
- The embedding form emulated over that plan, as the kernel walks it: the
  blocks take items in turn, sort each item's rows by (type id, word id),
  take them eight at a time (a warp a row: each warp's dgamma and dbeta
  partials), and add the eight in sorted order into the open word run, the
  open type run and the position's row; a word run goes into its table row
  when the id changes (stored where the batch gathers that row once, else
  added), runs stay open across a block's items; then dgamma, dbeta and a
  split position's rows are summed over the blocks in the kernel's order.
  It must give ``embed_ln_bwd_plain``'s gradients within ``BWD_RTOL`` of
  each one's max|ref| at all-ones ids, CLS/SEP/PAD ids from the tokenizer,
  random ids, negative and out-of-range ids (dgamma then NaN on both
  sides), type ids 0 and 1, a position offset, and grids that split a
  position over several items or give a block several positions.
- The residual form emulated likewise (a block's warps take rows in turn)
  against ``layer_norm_bwd_plain``.
- K9's cluster split emulated: clusters of 8 images, block r of a cluster
  projecting the r-th eighth of the columns for the cluster's images (none
  past the last image), each image's sum of squares added over the
  cluster in rank order; held to ``vision_head_plain`` and to the JAX
  ``VisionEncoderModel`` tail (run as ``tests/test_torch_vision.py`` runs
  it) at B = 1 and 13 and an embed width that is not a multiple of 8.
"""

from __future__ import annotations

import numpy as np
import pytest

import flax.linen as nn
import jax.numpy as jnp
import torch

import chip_smoke
from pathway_tpu_torch.kernels.add_layer_norm import layer_norm_bwd, layer_norm_bwd_plain
from pathway_tpu_torch.kernels.embed_ln import ITEM_ROWS, _rows, bwd_plan, embed_ln_bwd, embed_ln_bwd_plain
from pathway_tpu_torch.kernels.vision_head import NORM_EPS, vision_head, vision_head_plain
from pathway_tpu_torch.models import HashTokenizer

BWD_RTOL = chip_smoke.BWD_RTOL
EPS = 1e-12
WARPS = 8  # rows a block takes at a time (a warp each)
SUM_GROUPS = 32  # row groups of the final sum over the blocks' partial rows
CLUSTER = 8  # K9's blocks a cluster, an image each


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The small products run faster on one thread, and leave the other
    cores to the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(*shape, seed=0, scale=1.0):
    return torch.from_numpy((scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32))


# ---------------------------------------------------------------------------
# K17's item plan


@pytest.mark.parametrize("batch,seq,grid", [
    (64, 128, 264), (64, 128, 132), (8192, 1, 264), (1, 1, 264), (3, 8, 264), (1024, 512, 264),
    (300, 2, 132), (5, 7, 3), (600, 3, 1), (257, 1, 2),
])
def test_bwd_plan_covers_each_row_once(batch, seq, grid):
    chunks, rows = bwd_plan(batch, seq, grid)
    assert 1 <= rows <= ITEM_ROWS and chunks * rows >= batch
    seen = np.zeros((batch, seq), dtype=np.int64)
    for item in range(chunks * seq):
        l, b0 = item % seq, item // seq * rows
        n = min(rows, batch - b0)
        assert n >= 1, f"item {item} is empty"
        seen[b0:b0 + n, l] += 1
    assert (seen == 1).all()


# ---------------------------------------------------------------------------
# K17 emulated


def _ordered_sum(partial: torch.Tensor) -> torch.Tensor:
    """Sum of a [blocks, n] partial over the blocks as the kernel's last
    phase takes it: SUM_GROUPS row groups (block b in group b % SUM_GROUPS,
    each in block order), then the groups in order."""
    groups = [partial[g::SUM_GROUPS].sum(0) for g in range(min(SUM_GROUPS, partial.shape[0]))]
    out = groups[0].clone()
    for t in groups[1:]:
        out += t
    return out


def _row_grads(s: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor):
    """Per row: xhat and ds, as ``row_bwd`` computes them."""
    mean = s.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((s - mean) ** 2).mean(-1, keepdim=True) + EPS)
    xhat = (s - mean) * rstd
    g = dy * gamma
    ds = rstd * (g - g.mean(-1, keepdim=True) - xhat * (g * xhat).mean(-1, keepdim=True))
    return xhat, ds


def emulate_embed_bwd(dy, ids, type_ids, word, position, type_table, gamma, grid):
    B, L = ids.shape
    h = word.shape[1]
    chunks, rows = bwd_plan(B, L, grid)
    blocks = min(grid, chunks * L)
    wi, ok = _rows(word, ids.long())
    ti = torch.zeros_like(wi)
    s = word[wi] + position[:L][None]
    if type_table is not None:
        ti, tok = _rows(type_table, torch.zeros_like(wi) if type_ids is None else type_ids.long())
        ok = ok & tok
        s = s + type_table[ti]
    s = torch.where(ok[..., None], s, torch.full_like(s, float("nan")))
    dy = dy.reshape(B, L, h)
    xhat, ds = _row_grads(s, dy, gamma)
    counts = torch.bincount(wi[ok], minlength=word.shape[0])
    d_word = torch.zeros_like(word)
    d_position = torch.zeros_like(position)
    d_type = None if type_table is None else torch.zeros_like(type_table)
    pos_partial = torch.zeros((chunks * L, h))
    part_g, part_b = torch.zeros((blocks, h)), torch.zeros((blocks, h))

    def flush_word(key, run):
        w = key[1]
        if counts[w] == 1:
            d_word[w] = run
        else:
            d_word[w] += run

    for blk in range(blocks):
        acc_g, acc_b = torch.zeros((WARPS, h)), torch.zeros((WARPS, h))
        run_key, run = None, torch.zeros(h)
        run_type, trun = None, torch.zeros(h)
        for item in range(blk, chunks * L, blocks):
            l, b0 = item % L, item // L * rows
            n = min(rows, B - b0)
            keys = [(int(ti[b, l]), int(wi[b, l])) if ok[b, l] else None for b in range(b0, b0 + n)]
            order = sorted(range(n), key=lambda t: (keys[t] is None, keys[t] or (0, 0), t))
            pos = torch.zeros(h)
            for p0 in range(0, n, WARPS):
                wave = order[p0:p0 + WARPS]
                for w, t in enumerate(wave):
                    acc_g[w] += dy[b0 + t, l] * xhat[b0 + t, l]
                    acc_b[w] += dy[b0 + t, l]
                for t in wave:
                    key = keys[t]
                    if key is None:
                        break
                    if key != run_key:
                        if run_key is not None:
                            flush_word(run_key, run)
                        run_key, run = key, torch.zeros(h)
                        if type_table is not None and key[0] != run_type:
                            if run_type is not None:
                                d_type[run_type] += trun
                            run_type, trun = key[0], torch.zeros(h)
                    run = run + ds[b0 + t, l]
                    trun = trun + ds[b0 + t, l]
                    pos = pos + ds[b0 + t, l]
            if chunks == 1:
                d_position[l] = pos
            else:
                pos_partial[item] = pos
        if run_key is not None:
            flush_word(run_key, run)
        if run_type is not None:
            d_type[run_type] += trun
        part_g[blk] = sum(acc_g[w] for w in range(WARPS))
        part_b[blk] = sum(acc_b[w] for w in range(WARPS))
    if chunks > 1:
        d_position[:L] = sum(pos_partial[c * L:(c + 1) * L] for c in range(chunks))
    return d_word, d_position, d_type, _ordered_sum(part_g), _ordered_sum(part_b)


def _assert_close(got, want, what):
    for name, a, b in zip(("d_word", "d_position", "d_type", "dgamma", "dbeta"), got, want):
        if b is None:
            assert a is None, f"{what}: {name}"
            continue
        nan = torch.isnan(b)
        assert torch.equal(torch.isnan(a), nan), f"{what}: {name} NaN where the plain version is not"
        if nan.all():
            continue
        a, b = a[~nan], b[~nan]
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert err <= BWD_RTOL, f"{what}: {name} {err} of max|ref|"


VOCAB, HID, POS, TYPES = 1200, 32, 40, 2


def _tables(seed=0):
    return (_rand(VOCAB, HID, seed=seed, scale=0.05), _rand(POS, HID, seed=seed + 1, scale=0.05),
            _rand(TYPES, HID, seed=seed + 2, scale=0.05), 1 + 0.1 * _rand(HID, seed=seed + 3))


def _ids(kind: str, B: int, L: int, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if kind == "all_ones":
        return torch.ones((B, L), dtype=torch.int16)
    if kind == "tokenizer":
        # documents shorter and longer than L: CLS, SEP and PAD tails
        docs = [" ".join(f"w{w}" for w in rng.integers(0, 50_000, n)) for n in rng.integers(2, 2 * L, B)]
        ids = HashTokenizer(VOCAB).encode_batch(docs, max_len=L, bucket_len=False)[0]
        return torch.from_numpy(ids).to(torch.int16)
    if kind == "random":
        return torch.from_numpy(rng.integers(0, VOCAB, (B, L))).to(torch.int16)
    # negative ids wrap, ids past either end gather nothing
    ids = torch.from_numpy(rng.integers(-VOCAB, VOCAB, (B, L))).to(torch.int16)
    ids[0, 3], ids[2, 0], ids[1, 1] = VOCAB + 5, -VOCAB - 2, -5
    return ids


@pytest.mark.parametrize("grid", [5, 64], ids=lambda g: f"grid{g}")
@pytest.mark.parametrize("types", [False, True], ids=["no_type_ids", "type_ids"])
@pytest.mark.parametrize("kind", ["all_ones", "tokenizer", "random", "out_of_range"])
def test_embed_bwd_plan_emulated_matches_the_plain_version(kind, types, grid):
    B, L = 12, 16
    word, position, type_table, gamma = _tables()
    ids = _ids(kind, B, L)
    if kind == "tokenizer":
        assert (ids[:, 0] == 101).all() and (ids == 0).any(), "CLS at every row's start and a PAD tail"
    type_ids = torch.from_numpy(np.random.default_rng(5).integers(0, 2, (B, L))).to(torch.uint8) if types else None
    dy = _rand(B * L, HID, seed=9)
    want = embed_ln_bwd_plain(dy, ids, type_ids, word, position, type_table, gamma, EPS)
    got = emulate_embed_bwd(dy, ids, type_ids, word, position, type_table, gamma, grid)
    _assert_close(got, want, f"{kind}, grid {grid}")
    if kind == "out_of_range":
        assert torch.isnan(want[3]).all() and torch.isnan(got[3]).all()


def test_embed_bwd_plan_emulated_at_a_position_offset_and_no_type_table():
    # a block of a longer sequence reads the position table from its offset
    B, L = 9, 8
    word, position, type_table, gamma = _tables(seed=3)
    ids = _ids("random", B, L, seed=4)
    dy = _rand(B * L, HID, seed=10)
    for table in (type_table, None):
        want = embed_ln_bwd_plain(dy, ids, None, word, position[12:], table, gamma, EPS)
        got = emulate_embed_bwd(dy, ids, None, word, position[12:], table, gamma, 7)
        _assert_close(got, want, f"offset 12, type table {table is not None}")


def test_embed_ln_bwd_on_the_cpu_is_the_plain_version():
    B, L = 4, 8
    word, position, type_table, gamma = _tables(seed=6)
    ids, dy = _ids("tokenizer", B, L, seed=2), _rand(B * L, HID, seed=7)
    got = embed_ln_bwd(dy, ids, None, word, position, type_table, gamma, EPS)
    want = embed_ln_bwd_plain(dy, ids, None, word, position, type_table, gamma, EPS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def emulate_residual_bwd(dy, x, r, gamma, grid):
    m, h = x.shape
    blocks = min(grid, -(-m // WARPS))
    xhat, ds = _row_grads(x + r, dy, gamma)
    part_g, part_b = torch.zeros((blocks, h)), torch.zeros((blocks, h))
    for blk in range(blocks):
        acc_g, acc_b = torch.zeros((WARPS, h)), torch.zeros((WARPS, h))
        for w in range(WARPS):
            for row in range(blk * WARPS + w, m, blocks * WARPS):
                acc_g[w] += dy[row] * xhat[row]
                acc_b[w] += dy[row]
        part_g[blk] = sum(acc_g[w] for w in range(WARPS))
        part_b[blk] = sum(acc_b[w] for w in range(WARPS))
    return ds, _ordered_sum(part_g), _ordered_sum(part_b)


@pytest.mark.parametrize("m,grid", [(200, 7), (77, 64), (8, 3)])
def test_residual_bwd_emulated_matches_the_plain_version(m, grid):
    x, r, dy = _rand(m, HID, seed=1), _rand(m, HID, seed=2), _rand(m, HID, seed=3)
    gamma = 1 + 0.1 * _rand(HID, seed=4)
    want = layer_norm_bwd_plain(dy, x + r, gamma, EPS)
    for a, b in zip(emulate_residual_bwd(dy, x, r, gamma, grid), want):
        assert float((a - b).abs().max()) / float(b.abs().max()) <= BWD_RTOL
    for a, b in zip(layer_norm_bwd(dy, x, r, gamma, EPS), want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K9's cluster split emulated


def emulate_vision_head(x, weight, bias):
    """Clusters of 8 images; block r of a cluster means image r and
    projects columns [r ec, (r + 1) ec) for the cluster's images, four
    float4 steps of the reduction in turn into four sums added in order;
    each image's sum of squares over the cluster's blocks in rank order."""
    B, P, h = x.shape
    E = weight.shape[0]
    ec = -(-E // CLUSTER)
    pooled = x.float().mean(dim=1)
    out = torch.zeros((B, E))
    covered = torch.zeros((B, E), dtype=torch.int64)
    w4 = weight.reshape(E, h // 4, 4)
    steps = torch.arange(h // 4)
    for first in range(0, B, CLUSTER):
        imgs = torch.zeros((CLUSTER, h))
        n = min(CLUSTER, B - first)
        imgs[:n] = pooled[first:first + n]  # past the last image: zeros
        p4 = imgs.reshape(CLUSTER, h // 4, 4)
        proj, ssq = [], []
        for r in range(CLUSTER):
            e0, e1 = r * ec, min(E, (r + 1) * ec)
            dots = torch.einsum("qjk,ejk->qej", p4, w4[e0:e1])  # [images, columns, float4 steps]
            acc = [dots[..., (steps // 4) % 4 == a].sum(-1) for a in range(4)]
            block = acc[0] + acc[1] + acc[2] + acc[3] + bias[e0:e1]
            proj.append(block)
            ssq.append((block**2).sum(-1))
        total = ssq[0].clone()
        for t in ssq[1:]:
            total += t
        denom = torch.clamp(torch.sqrt(total), min=NORM_EPS)
        for r in range(CLUSTER):
            e0, e1 = r * ec, min(E, (r + 1) * ec)
            out[first:first + n, e0:e1] = proj[r][:n] / denom[:n, None]
            covered[first:first + n, e0:e1] += 1
    assert (covered == 1).all(), "each output written by exactly one block"
    return out


@pytest.mark.parametrize("B,E", [(1, 48), (13, 48), (13, 36), (8, 13)])
def test_vision_head_cluster_split_matches_plain_and_jax_tail(B, E):
    rng = np.random.default_rng(7)
    h = 64
    x = (rng.standard_normal((B, 16, h)) + 0.3).astype(np.float32)
    kernel = (0.2 * rng.standard_normal((h, E))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(E)).astype(np.float32)
    dense = nn.Dense(E, dtype=jnp.float32, param_dtype=jnp.float32)
    out = dense.apply({"params": {"kernel": kernel, "bias": bias}}, jnp.mean(jnp.asarray(x), axis=1))
    want_jax = np.asarray(out / jnp.maximum(jnp.sqrt(jnp.sum(out**2, axis=-1, keepdims=True)), 1e-12))
    xt, w, b = torch.from_numpy(x), torch.from_numpy(kernel.T.copy()), torch.from_numpy(bias)
    got = emulate_vision_head(xt, w, b)
    np.testing.assert_allclose(got.numpy(), vision_head_plain(xt, w, b).numpy(), atol=chip_smoke.HEAD_ATOL)
    np.testing.assert_allclose(got.numpy(), want_jax, atol=chip_smoke.HEAD_ATOL)
    assert torch.equal(vision_head(xt, w, b), vision_head_plain(xt, w, b))
