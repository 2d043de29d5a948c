"""Ring attention (K14's plain version, ``ops/ring_attention.py``) and the
sequence-parallel encoder against the JAX package, on the CPU; and the
argument checks of the kernels that the f32 configs and the ring need.

The JAX side runs on the virtual 8-device CPU mesh (``conftest.py``);
the port's mesh names the CPU device eight times.  Inputs are seeded
numpy arrays handed to both.  Tolerances:

- ``ring_block_plain`` against ``_ring_body``'s state after every step:
  1e-6 (f32, the same operations in the same order but for the products'
  summation);
- ``ring_attention`` against the JAX ``ring_attention``: 2e-4, as the
  JAX package's own test holds its ring to local attention;
- the encoder with ``seq_mesh`` against the flax one with ``seq_mesh``:
  3e-4, and ``TorchEncoder(sequence_axis=)`` against
  ``JittedEncoder(sequence_axis=)``: 2e-3, the JAX package's own
  tolerances for the same comparisons against local attention.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from pathway_tpu.models import TextEncoderModel as JaxEncoder
from pathway_tpu.ops import ring_attention as jax_ring
from pathway_tpu.parallel import JittedEncoder
from pathway_tpu.parallel import make_mesh as jax_make_mesh
from pathway_tpu_torch import make_mesh
from pathway_tpu_torch.kernels import ring_block, ring_block_plain, ring_state
from pathway_tpu_torch.kernels.add_layer_norm import check_add_layer_norm
from pathway_tpu_torch.kernels.attention import attention_plain, check_attention, walked_key_tiles
from pathway_tpu_torch.kernels.bias_act import check_bias_act
from pathway_tpu_torch.kernels.embed_ln import check_embed_ln
from pathway_tpu_torch.kernels.pool_normalize import check_pool_normalize
from pathway_tpu_torch.kernels.ring_block import MAX_RING_LEN, check_ring_block, walked_ring_tiles
from pathway_tpu_torch.models import TextEncoderModel, state_dict_from_flax
from pathway_tpu_torch.ops.ring_attention import any_keys, local_attention, ring_attention, ring_attention_plain
from pathway_tpu_torch.parallel import TorchEncoder
from test_torch_encoder import port_config

CPU8 = ["cpu"] * 8
TINY = dataclasses.replace(graft._flagship_config(tiny=True), dtype=jnp.float32)


def _port_cfg(jcfg, mesh=None, axis="data"):
    """The port's config of a JAX one, with the port's mesh for seq_mesh."""
    cfg = port_config(dataclasses.replace(jcfg, seq_mesh=None))
    return dataclasses.replace(cfg, seq_mesh=mesh, seq_axis=axis)


# ---------------------------------------------------------------------------
# C5: what the kernels take (device-independent checks; the kernels run on
# the card)


def _heads(B, L, H, D, dtype):
    return [torch.zeros((B, L, H, D), dtype=dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_attention_takes_f32_and_head_dim_16(dtype, D):
    q, k, v = _heads(2, 16, 4, D, dtype)
    check_attention(q, k, v, torch.ones((2, 16), dtype=torch.uint8))
    o, m, l = ring_state(2, 16, 4, D, "cpu")
    check_ring_block(q, k, v, torch.ones((2, 16), dtype=torch.uint8), o, m, l)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_kernels_take_f32_activations(dtype):
    y = torch.zeros((6, 64), dtype=dtype)
    f32 = torch.zeros(64)
    for act in ("none", "gelu_tanh", "gelu_erf", "tanh"):
        check_bias_act(y, f32, act)
    check_bias_act(y, f32, "none", pos=torch.zeros((3, 64)))
    check_add_layer_norm(y, y.clone(), f32, f32)
    ids = torch.zeros((2, 3), dtype=torch.int16)
    position = torch.zeros((64, 64))
    check_embed_ln(ids, None, torch.zeros((100, 64)), position, torch.zeros((2, 64)), f32, f32, dtype)
    check_embed_ln(ids, None, torch.zeros((100, 64)), position[32:], None, f32, f32, dtype)
    for pool in ("cls", "mean"):
        check_pool_normalize(y.view(2, 3, 64), torch.ones((2, 3), dtype=torch.uint8), pool)


def test_walked_key_tiles_skip_masked_tiles_and_walk_all_for_an_empty_row():
    L = 196  # 4 key tiles, the last partial
    mask = torch.zeros((6, L), dtype=torch.uint8)
    mask[0] = 1
    mask[1, 130:140] = 1            # only tile 2
    mask[2, :3] = 1
    mask[2, L - 2] = 1              # tiles 0 and 3, masked tiles between
    mask[4, L - 1] = 1              # only the last key
    mask[5, 64:128] = 1             # exactly tile 1
    # row 3 has no present key: every tile is walked (uniform average of v)
    assert walked_key_tiles(mask).tolist() == [4, 1, 2, 4, 1, 1]
    assert walked_key_tiles(torch.ones((2, 64), dtype=torch.uint8)).tolist() == [1, 1]
    assert walked_key_tiles(torch.zeros((1, 512), dtype=torch.uint8)).tolist() == [8]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_skipping_fully_masked_key_tiles_is_exact(dtype):
    # the kernel's tile skip, in the plain arithmetic: attention over only
    # the walked tiles' keys (their masked keys still biased) gives what
    # attention over every key gives
    g = torch.Generator().manual_seed(7)
    B, L, H, D = 3, 196, 2, 32
    q, k, v = (torch.randn((B, L, H, D), generator=g).to(dtype) for _ in range(3))
    mask = torch.zeros((B, L), dtype=torch.uint8)
    mask[0, 10:20] = 1
    mask[0, 150:160] = 1
    mask[1, 64:70] = 1
    mask[2, 195] = 1
    full = attention_plain(q, k, v, mask)
    for b in range(B):
        keep = torch.cat([torch.arange(t * 64, min(L, t * 64 + 64)) for t in range(4)
                          if bool(mask[b, t * 64:t * 64 + 64].any())])
        # the keys of skipped tiles drop out: q keeps all L rows, k/v only the walked keys
        logits = torch.einsum("lhd,mhd->hlm", q[b], k[b, keep]).float() / D ** 0.5
        bias = torch.where(mask[b, keep].bool()[None, None, :], 0.0, -1e30)
        probs = torch.softmax(logits + bias, dim=-1).to(dtype)
        got = torch.einsum("hlm,mhd->lhd", probs, v[b, keep])
        torch.testing.assert_close(got.float(), full[b].float(), rtol=0,
                                   atol=1e-6 if dtype == torch.float32 else 2e-2)


def test_attention_tensor_map_strides():
    # bf16 K/V tiles come through a [B, L, H, D] tensor map: a batch row's
    # stride must be under 2^40 bytes (the others are whole 32 bytes)
    for D in (16, 32, 64):
        q, k, v = _heads(1, 1, 1, D, torch.bfloat16)
        check_attention(q, k, v, torch.ones((1, 1), dtype=torch.uint8))
    huge = torch.empty((1, 512, 2**24, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="tensor map"):
        check_attention(huge, huge, huge, torch.empty((1, 512), dtype=torch.uint8, device="meta"))
    f32 = torch.empty((1, 512, 2**24, 64), dtype=torch.float32, device="meta")  # no TMA in f32
    check_attention(f32, f32, f32, torch.empty((1, 512), dtype=torch.uint8, device="meta"))


def test_kernel_checks_still_refuse_what_the_kernels_do_not_take():
    q, k, v = _heads(2, 16, 4, 16, torch.float32)
    mask = torch.ones((2, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="head_dim"):
        check_attention(*_heads(2, 16, 4, 8, torch.float32), mask)
    with pytest.raises(ValueError, match="one type"):
        check_attention(q, k.bfloat16(), v, mask)
    with pytest.raises(ValueError, match="float16|bf16 or f32"):
        check_attention(q.half(), k.half(), v.half(), mask)
    with pytest.raises(ValueError, match="sequence length"):
        check_attention(*_heads(1, 513, 1, 16, torch.float32), torch.ones((1, 513), dtype=torch.uint8))
    o, m, l = ring_state(2, 16, 4, 16, "cpu")
    with pytest.raises(ValueError, match="state"):
        check_ring_block(q, k, v, mask, o.transpose(1, 2), m, l)
    with pytest.raises(ValueError, match="f32"):
        check_ring_block(q, k, v, mask, o.double(), m, l)
    # K14 takes blocks of 2,048 keys and more, up to MAX_RING_LEN (its walk's
    # shared memory grows with the block)
    check_ring_block(*_heads(1, 4096, 1, 16, torch.bfloat16), torch.ones((1, 4096), dtype=torch.uint8),
                     *ring_state(1, 4096, 1, 16, "cpu"))
    with pytest.raises(ValueError, match="bf16 or f32"):
        check_bias_act(torch.zeros((2, 8), dtype=torch.float16), torch.zeros(8), "none")
    with pytest.raises(ValueError, match="one type"):
        check_add_layer_norm(torch.zeros((2, 8)), torch.zeros((2, 8), dtype=torch.bfloat16),
                             torch.zeros(8), torch.zeros(8))
    with pytest.raises(ValueError, match="writes bf16 or f32"):
        check_embed_ln(torch.zeros((1, 2), dtype=torch.int16), None, torch.zeros((4, 8)),
                       torch.zeros((4, 8)), None, torch.zeros(8), torch.zeros(8), torch.float16)
    with pytest.raises(ValueError, match="bf16 or f32"):
        check_pool_normalize(torch.zeros((1, 2, 8), dtype=torch.float16),
                             torch.ones((1, 2), dtype=torch.uint8), "cls")


def test_ring_block_checks_the_block_length_and_any_key():
    meta = dict(device="meta")
    big = torch.empty((1, MAX_RING_LEN, 1, 16), dtype=torch.bfloat16, **meta)
    state = (torch.empty((1, 1, MAX_RING_LEN, 16), **meta), torch.empty((1, 1, MAX_RING_LEN), **meta),
             torch.empty((1, 1, MAX_RING_LEN), **meta))
    check_ring_block(big, big, big, torch.empty((1, MAX_RING_LEN), dtype=torch.uint8, **meta), *state)
    n = MAX_RING_LEN + 64
    over = torch.empty((1, n, 1, 16), dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="block length"):
        check_ring_block(over, over, over, torch.empty((1, n), dtype=torch.uint8, **meta),
                         torch.empty((1, 1, n, 16), **meta), torch.empty((1, 1, n), **meta),
                         torch.empty((1, 1, n), **meta))
    q, k, v = _heads(2, 16, 4, 16, torch.float32)
    mask = torch.ones((2, 16), dtype=torch.uint8)
    st = ring_state(2, 16, 4, 16, "cpu")
    check_ring_block(q, k, v, mask, *st, torch.ones(2, dtype=torch.uint8))
    with pytest.raises(ValueError, match="any_key"):
        check_ring_block(q, k, v, mask, *st, torch.ones(3, dtype=torch.uint8))
    with pytest.raises(ValueError, match="any_key"):
        check_ring_block(q, k, v, mask, *st, torch.ones(2, dtype=torch.bool))


def test_ring_block_off_the_cpu_needs_any_key():
    # the kernel's wrapper has no default for the tile-skip flag: a tensor
    # off the CPU ("meta" stands in for a card) without it is refused before
    # anything is launched; on the CPU the plain step runs without it
    meta = [t.to("meta") for t in (*_heads(2, 16, 4, 16, torch.float32), torch.ones((2, 16), dtype=torch.uint8),
                                   *ring_state(2, 16, 4, 16, "cpu"))]
    with pytest.raises(ValueError, match="needs any_key"):
        ring_block(*meta)
    q, k, v = _heads(2, 16, 4, 16, torch.float32)
    assert ring_block(q, k, v, torch.ones((2, 16), dtype=torch.uint8), *ring_state(2, 16, 4, 16, "cpu"),
                      finalize=True).shape == q.shape


def test_walked_ring_tiles_follow_the_whole_sequence():
    L = 2048  # 32 key tiles
    mask = torch.zeros((4, L), dtype=torch.uint8)
    mask[0] = 1
    mask[1, 100:140] = 1     # tiles 1 and 2
    # row 2: its present keys are in another block; row 3: none anywhere
    any_key = torch.tensor([1, 1, 1, 0], dtype=torch.uint8)
    assert walked_ring_tiles(mask, any_key).tolist() == [32, 2, 0, 32]
    # without the sequence's flags (or all zero) every tile is walked
    assert walked_ring_tiles(mask).tolist() == [32] * 4
    assert walked_ring_tiles(mask, torch.zeros(4, dtype=torch.uint8)).tolist() == [32] * 4
    # one block of 8,192 keys: 128 tiles; a partial last tile counts
    long = torch.zeros((2, 8192 - 5), dtype=torch.uint8)
    long[0, -1] = 1
    long[1, 64 * 7] = 1
    assert walked_ring_tiles(long, torch.ones(2, dtype=torch.uint8)).tolist() == [1, 1]
    assert walked_ring_tiles(long, torch.tensor([0, 1], dtype=torch.uint8)).tolist() == [128, 1]


def _walked_step(q, k, v, mask, any_key, o, m, l):
    """The plain step arithmetic of ring_block_plain over only the key
    tiles the kernel walks (walked_ring_tiles's: present tiles where
    any_key, else all), batch row by batch row; a row with no walked tile
    keeps its state."""
    B, L, H, D = q.shape
    for b in range(B):
        tiles = [t for t in range(-(-L // 64))
                 if not any_key[b] or bool(mask[b, t * 64:(t + 1) * 64].any())]
        if not tiles:
            continue
        keep = torch.cat([torch.arange(t * 64, min(L, t * 64 + 64)) for t in tiles])
        st = (o[b:b + 1].clone(), m[b:b + 1].clone(), l[b:b + 1].clone())
        ring_block_plain(q[b:b + 1], k[b:b + 1, keep], v[b:b + 1, keep], mask[b:b + 1, keep], *st)
        o[b], m[b], l[b] = st[0][0], st[1][0], st[2][0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skipping_tiles_is_exact_across_ring_steps(seed):
    # the kernel's walk in the plain arithmetic, step after step, gives the
    # output of ring_block_plain over every key: rows whose present keys lie
    # in later blocks (masked blocks first), in one block only, in none
    n, B, lb, H, D = 4, 6, 256, 2, 16
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((n, B, lb, H, D), generator=g) for _ in range(3))
    mask = (torch.rand((n, B, lb), generator=g) < 0.3).to(torch.uint8)
    mask[:, :, 64:192] = 0         # the middle tiles of every block are masked
    mask[:3, 1] = 0                # row 1: present keys only in the last block
    mask[:, 2] = 0                 # row 2: none anywhere (the uniform average of v)
    mask[1:, 3] = 0                # row 3: present keys only in the first block
    mask[:, 4] = 0
    mask[2, 4, 250] = 1            # row 4: one present key, in block 2
    any_key = mask.amax(dim=(0, 2))
    assert any_key.tolist() == [1, 1, 0, 1, 1, 1]
    want = [ring_state(B, lb, H, D, "cpu") for _ in range(n)]
    got = [ring_state(B, lb, H, D, "cpu") for _ in range(n)]
    for s in range(n):
        last = s == n - 1
        for i in range(n):
            src = (i - s) % n
            out_w = ring_block_plain(q[i], k[src], v[src], mask[src], *want[i], finalize=last)
            if not last:
                _walked_step(q[i], k[src], v[src], mask[src], any_key, *got[i])
                continue
            o, m, l = (t.clone() for t in got[i])
            _walked_step(q[i], k[src], v[src], mask[src], any_key, o, m, l)
            out_g = (o / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2)
            torch.testing.assert_close(out_g, out_w, rtol=0, atol=1e-6)
    # the walk visited far fewer tiles than the whole sequence holds
    walked = sum(int(walked_ring_tiles(mask[j], any_key).sum()) for j in range(n))
    assert walked < n * B * (lb // 64) // 2


def test_any_keys_meet_on_the_first_device():
    masks = [torch.zeros((3, 8), dtype=torch.uint8) for _ in range(4)]
    masks[0][0, 3] = 1
    masks[2][1, 7] = 1
    whole = any_keys(masks)
    assert len(whole) == 4 and all(w.tolist() == [1, 1, 0] for w in whole)
    assert all(w.dtype == torch.uint8 for w in whole)


def test_ring_attention_matches_jax_when_a_row_has_no_key_in_its_own_block():
    rng = np.random.default_rng(5)
    b, l, h, d = 3, 64, 2, 16  # 8 blocks of 8 keys
    q, k, v = (rng.normal(size=(b, l, h, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, l), np.int32)
    mask[0, :] = 0
    mask[0, 40:44] = 1  # row 0: present keys only in block 5
    mask[1, 8:] = 0     # row 1: only in block 0
    jmesh = jax_make_mesh()
    want = np.asarray(jax.jit(lambda q, k, v, m: jax_ring.ring_attention(q, k, v, m, mesh=jmesh))(
        *map(jnp.asarray, (q, k, v, mask))))
    mesh = make_mesh({"data": 8}, CPU8)
    got = ring_attention(*map(torch.from_numpy, (q, k, v, mask)), mesh=mesh)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), local_attention(*map(torch.from_numpy, (q, k, v, mask))).numpy(),
                               rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# K14's plain version against _ring_body, step by step


def _ring_body_states(q, k, v, mask, monkeypatch):
    """Run ``_ring_body`` on ``n`` blocks (vmap over a named axis: its
    ppermute is the ring) and record (o, m, l) of every device after
    every step; returns ([step][device] -> (o, m, l)), the output)."""
    n = q.shape[0]
    rec: list = []

    def record_scan(f, init, xs, length):
        carry = init
        for _ in range(length):
            carry, _ = f(carry, None)
            jax.debug.callback(
                lambda i, o, m, l: rec.append((int(i), np.asarray(o), np.asarray(m), np.asarray(l))),
                jax.lax.axis_index("ring"), *carry[:3],
            )
        return carry, None

    monkeypatch.setattr(jax.lax, "scan", record_scan)
    body = functools.partial(jax_ring._ring_body, axis_name="ring", n_shards=n)
    out = np.asarray(jax.vmap(body, axis_name="ring")(q, k, v, mask))
    monkeypatch.undo()
    assert len(rec) == n * n
    states = [[None] * n for _ in range(n)]
    for j, (dev, o, m, l) in enumerate(rec):
        states[j // n][dev] = (o, m, l)
    return states, out


@pytest.mark.parametrize("seed", [0, 1])
def test_ring_block_plain_steps_match_ring_body(seed, monkeypatch):
    n, B, lb, H, D = 4, 3, 8, 2, 16
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((n, B, lb, H, D)).astype(np.float32) for _ in range(3))
    mask = (rng.random((n, B, lb)) < 0.5).astype(np.int32)
    mask[:, 2] = 0  # a row with no valid key anywhere: the uniform average of v
    mask[1:, 1] = 0  # a row whose only valid keys are in block 0
    states, want_out = _ring_body_states(q, k, v, mask, monkeypatch)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tm = torch.from_numpy(mask.astype(np.uint8))
    port = [ring_state(B, lb, H, D, "cpu") for _ in range(n)]
    for s in range(n):
        for i in range(n):
            src = (i - s) % n
            ring_block_plain(t[0][i], t[1][src], t[2][src], tm[src], *port[i])
            for got, want in zip(port[i], states[s][i]):
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the finishing step: ring_block (the plain version on CPU tensors) again
    # from the state after n - 1 steps
    port = [ring_state(B, lb, H, D, "cpu") for _ in range(n)]
    for s in range(n):
        for i in range(n):
            src = (i - s) % n
            out = ring_block(t[0][i], t[1][src], t[2][src], tm[src], *port[i], finalize=s == n - 1)
            if s == n - 1:
                np.testing.assert_allclose(out.numpy(), want_out[i], rtol=1e-6, atol=1e-6)
    uniform = np.concatenate(list(v), axis=1)[2].mean(axis=0)
    np.testing.assert_allclose(want_out[:, 2], np.broadcast_to(uniform, want_out[:, 2].shape), atol=1e-6)


# ---------------------------------------------------------------------------
# ring_attention against the JAX package's


def test_ring_attention_matches_jax_and_local():
    rng = np.random.default_rng(3)
    b, l, h, d = 2, 32, 4, 16  # L over 8 devices -> 4 per device
    q, k, v = (rng.normal(size=(b, l, h, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, l), np.int32)
    mask[1, 20:] = 0  # padded tail on one sequence
    jmesh = jax_make_mesh()
    want = np.asarray(jax.jit(lambda q, k, v, m: jax_ring.ring_attention(q, k, v, m, mesh=jmesh))(
        *map(jnp.asarray, (q, k, v, mask))))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tmask = torch.from_numpy(mask)
    mesh = make_mesh({"data": 8}, CPU8)
    got = ring_attention(tq, tk, tv, tmask, mesh=mesh)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), local_attention(tq, tk, tv, tmask).numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(ring_attention_plain(tq, tk, tv, tmask, mesh=mesh).numpy(), got.numpy())
    # per-device blocks in, blocks out; no mask means every key present
    blocks = [t.chunk(8, dim=1) for t in (tq, tk, tv)]
    outs = ring_attention(*blocks, [m.to(torch.uint8) for m in tmask.chunk(8, dim=1)], mesh=mesh)
    np.testing.assert_array_equal(torch.cat(outs, dim=1).numpy(), got.numpy())
    want_full = np.asarray(jax_ring.local_attention(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(ring_attention(tq, tk, tv, mesh=mesh).numpy(), want_full, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="divide"):
        ring_attention(tq[:, :30], tk[:, :30], tv[:, :30], mesh=mesh)
    with pytest.raises(ValueError, match="blocks"):  # the list form: one block per device
        ring_attention(*[bl[:4] for bl in blocks], mesh=mesh)


# ---------------------------------------------------------------------------
# the ring's stream and event order on distinct cards, simulated: streams
# carry vector clocks, so "the copy reads the block after it was written"
# is a comparison of clocks


class _Stream:
    count = 0

    def __init__(self, device):
        _Stream.count += 1
        self.id, self.device, self.clock = _Stream.count, torch.device(device), {}

    def op(self) -> dict:
        """One operation enqueued here; its clock."""
        self.clock[self.id] = self.clock.get(self.id, 0) + 1
        return dict(self.clock)

    def wait_event(self, event) -> None:
        for k, c in event.clock.items():
            self.clock[k] = max(self.clock.get(k, 0), c)


class _Event:
    def __init__(self):
        self.clock = {}

    def record(self, stream) -> None:
        self.clock = dict(stream.clock)


def _before(a: dict, b: dict) -> bool:
    """Operation ``a`` happens before operation ``b``."""
    return all(b.get(k, 0) >= c for k, c in a.items())


class _Cards:
    """``torch.cuda``'s streams and events for the ring, and its copies
    between cards as ATen's ``copy_device_to_device`` issues them: on the
    source's current stream, after it waits for the destination's current
    stream, which then waits for the copy."""

    def __init__(self):
        self.compute, self.current = {}, {}

    def current_stream(self, device):
        device = torch.device(device)
        if device not in self.current:
            self.current[device] = self.compute[device] = _Stream(device)
        return self.current[device]

    def stream(self, s):
        cards = self

        class _Ctx:
            def __enter__(self):
                self.prev = cards.current_stream(s.device)
                cards.current[s.device] = s

            def __exit__(self, *exc):
                cards.current[s.device] = self.prev

        return _Ctx()

    def copy(self, block, device):
        src, dst = self.current_stream(block.device), self.current_stream(device)
        src.wait_event(_ev(dst))
        stamp = src.op()
        assert _before(block.written, stamp), "a block was copied on before it had arrived"
        dst.wait_event(_ev(src))
        return _Block(device, block.origin, stamp)


def _ev(stream) -> _Event:
    e = _Event()
    e.record(stream)
    return e


class _Block:
    """A K/V/mask tensor on a simulated card: where it started and the
    clock of the operation that wrote it."""

    cards: _Cards

    def __init__(self, device, origin, written):
        self.device, self.origin, self.written = torch.device(device), origin, written
        self.shape = (1, 4, 1, 16)

    def to(self, device, non_blocking=False):
        return self if torch.device(device) == self.device else self.cards.copy(self, device)

    def record_stream(self, stream) -> None:
        pass

    def _op(self, *read) -> "_Block":
        """An operation on this card's current stream that reads ``read``."""
        stamp = self.cards.current_stream(self.device).op()
        for t in read:
            assert t.device == self.device and _before(t.written, stamp), "a block was read before it arrived"
        return _Block(self.device, "any_key", stamp)

    def amax(self, dim):
        return self._op(self)

    def __or__(self, other):
        return self._op(self, other)


@pytest.mark.parametrize("cards", [[0, 1, 2], [0, 1, 2, 3], [0, 0, 1, 1], [0, 0, 0]])
def test_ring_hand_on_waits_for_each_block_and_overlaps_the_step(cards, monkeypatch):
    """On distinct cards every step reads its block after the copy that
    brought it, and every copy reads its block after that block arrived
    (the copy of step s + 1 is issued while step s runs); a copy waits
    neither for the step the source runs meanwhile nor holds back the
    destination's; device i at step s works on the block of i - s."""
    from pathway_tpu_torch.ops import ring_attention as ring_mod

    sim = _Cards()
    _Block.cards = sim
    monkeypatch.setattr(torch.cuda, "current_stream", sim.current_stream)
    monkeypatch.setattr(torch.cuda, "stream", sim.stream)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(ring_mod, "ring_state", lambda *a: ())
    monkeypatch.setattr(ring_mod, "_SIDE", {})
    n = len(cards)
    devices = [torch.device("cuda", c) for c in cards]
    made = [sim.current_stream(d).op() for d in devices]  # each block's q/k/v, made on its device
    blocks = [[_Block(d, i, made[i]) for i, d in enumerate(devices)] for _ in range(4)]
    launches, copies = [], []
    real_copy = sim.copy

    def copy(block, device):
        moved = real_copy(block, device)
        kv = isinstance(block.origin, int)  # a K/V/mask block, not a part of any_key
        copies.append((len(launches) // n, block.device, device, kv or None, moved.written))
        return moved

    sim.copy = copy

    def step(q, k, v, mask, finalize=False, any_key=None):
        stamp = sim.current_stream(q.device).op()
        for t in (k, v, mask, any_key):  # any_key: the batch rows with a present key anywhere
            assert t.device == q.device
            assert _before(t.written, stamp), "a step read its block before the copy had brought it"
        launches.append((q.device, k.origin, stamp))
        return q

    ring_mod.ring_attention_blocks(*blocks, step=step)
    assert [origin for _, origin, _ in launches] == [(i - s) % n for s in range(n) for i in range(n)]
    # any_key's parts meet on the first card and go back to the others, before the first step
    flags = [c for c in copies if c[3] is None]
    copies = [c[:3] + (c[4],) for c in copies if c[3] is not None]
    assert len(flags) == sum(c != cards[0] for c in cards) + len(set(cards) - {cards[0]})
    assert all(s == 0 for s, *_ in flags)
    assert len(copies) == 3 * sum(cards[i] != cards[i - 1] for i in range(n)) * (n - 1)  # k, v, mask
    for s, src, dst, stamp in copies:  # issued before step s's launches
        for dev, _, launched in launches[s * n : (s + 1) * n]:
            if dev in (src, dst):
                assert not _before(launched, stamp), "a copy waited for the step it should overlap"
                assert not _before(stamp, launched), "a step waited for the next step's copy"
    made = _Stream.count  # the side streams are made once: the allocator's pools are reused
    ring_mod.ring_attention_blocks(*blocks, step=step)
    assert _Stream.count == made


# ---------------------------------------------------------------------------
# the sequence-parallel encoder


def _edge_mask(B=8, L=1024):
    """test_tpu_plane.py's edge rows over 8 blocks of 128, plus a full row."""
    mask = np.zeros((B, L), np.int32)
    mask[0, :127] = 1    # one token short of the first block boundary
    mask[1, :128] = 1    # exactly one block
    mask[2, :129] = 1    # one token into the second block
    mask[3, :1023] = 1   # one short of full length
    mask[4, 256:384] = 1  # valid tokens only inside block 2
    mask[5, :1] = 1      # a single valid token
    # mask[6] stays all zero: the fully masked row
    mask[7, :700] = 1    # a ragged tail across blocks
    return mask


@pytest.mark.parametrize("pool", ["mean", "cls"])
def test_text_encoder_seq_mesh_matches_flax(pool):
    jcfg = dataclasses.replace(TINY, max_len=1024, pool=pool)
    jmesh = jax_make_mesh()
    rng = np.random.default_rng(11)
    ids = rng.integers(0, jcfg.vocab_size, size=(8, 1024)).astype(np.int32)
    mask = _edge_mask()
    jlocal = JaxEncoder(jcfg)
    params = jlocal.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))
    jring = JaxEncoder(dataclasses.replace(jcfg, seq_mesh=jmesh, seq_axis="data"))
    want = np.asarray(jax.jit(jring.apply)(params, jnp.asarray(ids), jnp.asarray(mask)))
    mesh = make_mesh({"data": 8}, CPU8)
    cfg = _port_cfg(jcfg, mesh)
    tm = TextEncoderModel(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params), cfg))
    assert len(tm._grid) == 8 and all(row == [tm] for row in tm.cells())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    if pool == "mean":
        np.testing.assert_allclose(got[6], 0.0, atol=1e-6)  # the fully masked row pools to zero
    # a 1-device sequence axis: K14's plain version in one step over all keys
    one = TextEncoderModel(_port_cfg(jcfg, make_mesh({"data": 1}, ["cpu"])), device="cpu")
    one.load_state_dict(tm.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(one(torch.from_numpy(ids), torch.from_numpy(mask)).numpy(), got,
                                   rtol=3e-4, atol=3e-4)


@pytest.fixture(scope="module")
def sp_pair():
    jcfg = dataclasses.replace(TINY, max_len=256)
    jenc = JittedEncoder(jcfg, mesh=jax_make_mesh(), sequence_axis="data")
    tenc = TorchEncoder(_port_cfg(jcfg), params=jax.tree.map(np.asarray, jenc.params),
                        mesh=make_mesh({"data": 8}, CPU8), sequence_axis="data")
    return jenc, tenc


@pytest.mark.parametrize("docs", [
    ["short text", "long document " * 120],
    ["w " * 31, "w " * 32, "w " * 33, "w " * 255, "w"],
], ids=["short_and_long", "bucket_boundaries"])
def test_torch_encoder_sequence_axis_matches_jax(sp_pair, docs):
    jenc, tenc = sp_pair
    assert tenc.config.seq_mesh is tenc.mesh and tenc._dp == 1
    got, want = tenc.encode(docs), jenc.encode(docs)
    assert got.shape == want.shape == (len(docs), 64)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_torch_encoder_sequence_axis_encode_into_and_errors(sp_pair):
    from pathway_tpu.parallel import ShardedKnnIndex as JaxIndex

    from pathway_tpu_torch.parallel import ShardedKnnIndex

    jenc, tenc = sp_pair
    docs = [f"doc {i} " + "word " * (i * 9) for i in range(20)]
    jidx, tidx = JaxIndex(64, capacity=64), ShardedKnnIndex(64, capacity=64, device="cpu")
    assert jenc.encode_into(jidx, range(20), docs) == tenc.encode_into(tidx, range(20), docs) == 20
    q = tenc.encode(docs[:4])
    for (ja, tb) in zip(jidx.search(q, 3), tidx.search(q, 3)):
        assert [k for k, _ in ja] == [k for k, _ in tb]
    with pytest.raises(ValueError, match="mesh containing"):
        TorchEncoder(_port_cfg(TINY), sequence_axis="data", device="cpu")
    with pytest.raises(ValueError, match="mesh containing"):
        TorchEncoder(_port_cfg(TINY), mesh=make_mesh({"data": 8}, CPU8), sequence_axis="seq")
    with pytest.raises(ValueError, match="must divide"):
        TorchEncoder(_port_cfg(TINY), mesh=make_mesh({"data": 8}, CPU8), sequence_axis="data", max_len=100)


def test_torch_encoder_sequence_axis_score_pairs_matches_jax():
    """The cross-encoder on the sequence axis: the pooler reads the CLS row
    of the first block."""
    jcfg = dataclasses.replace(TINY, max_len=128, num_labels=1, pool="cls", normalize=False)
    jenc = JittedEncoder(jcfg, cross=True, mesh=jax_make_mesh({"data": 4}, jax.devices()[:4]),
                         sequence_axis="data")
    tenc = TorchEncoder(_port_cfg(jcfg), cross=True, params=jax.tree.map(np.asarray, jenc.params),
                        mesh=make_mesh({"data": 4}, CPU8[:4]), sequence_axis="data")
    queries = ["what is long", "short", "w " * 50]
    docs = ["a long passage " * 20, "x", "y " * 70]
    np.testing.assert_allclose(tenc.score_pairs(queries, docs), jenc.score_pairs(queries, docs),
                               rtol=2e-3, atol=2e-3)
