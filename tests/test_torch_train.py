"""The port's contrastive train step against the JAX package's, on the CPU.

``__graft_entry__``'s ``loss_fn`` / ``train_step`` (B15) at the tiny
flagship config (hidden 64, 4 heads of 16, MLP 128, 2 layers, f32, CLS
pool): the same flax parameters (``state_dict_from_flax``) and the same
numpy batch go through ``jax.value_and_grad`` + ``optax.adam(1e-4)`` and
through ``pathway_tpu_torch.train`` (the kernels' plain versions and their
backward on the CPU).  Tolerances:

- the loss within 1e-6 relative (f32 sums in another order);
- each gradient tensor within ``1e-5 * max|g_jax| + 1e-8``;
- K19's plain version within 1e-7 of optax's parameters after 3 steps on
  JAX's own gradients (the same f32 arithmetic, in optax's order);
- a whole step's parameters within ``2 * lr`` of JAX's everywhere and
  within ``1e-2 * lr`` where ``|g_jax| >= 1e-4 * max|g_jax|``: Adam's
  ``g / (|g| + eps)`` turns a gradient's last-bit noise near 0 into a step
  of up to ``lr``;
- the ``{"data": 2, "model": 2}`` mesh step within 1e-6 of one device's.

Each autograd Function's backward is held against autograd of its plain
version.
"""

from __future__ import annotations

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import __graft_entry__ as graft
import pathway_tpu_torch
from pathway_tpu.models import TextEncoderModel as JaxEncoder
from pathway_tpu_torch import train
from pathway_tpu_torch.kernels.add_layer_norm import AddLayerNormFunction, add_layer_norm_plain
from pathway_tpu_torch.kernels.attention import AttentionFunction, attention_plain
from pathway_tpu_torch.kernels.bias_act import BiasActFunction, _activate, bias_act_plain
from pathway_tpu_torch.kernels.contrastive_loss import contrastive_loss_plain, in_batch_loss
from pathway_tpu_torch.kernels.embed_ln import EmbedLnFunction, embed_ln_plain
from pathway_tpu_torch.kernels.pool_normalize import PoolNormalizeFunction, pool_normalize_plain
from pathway_tpu_torch.models import TextEncoderModel, state_dict_from_flax
from pathway_tpu_torch.models.convert import adam_state_from_optax, adam_state_to_optax, state_dict_to_flax
from pathway_tpu_torch.parallel import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models' small products run faster on one thread, and leave
    the other cores to the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_cfg():
    return train.flagship_config(tiny=True)


def jax_cfg():
    return graft._flagship_config(tiny=True)


def batch(B: int = 6, L: int = 16, seed: int = 0):
    """Ids from numpy seed 0, ragged masks and one row with no present key."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1000, jax_cfg().vocab_size, (B, L)).astype(np.int32)
    lens = np.array([L, 3, 9, 0, 12, 5, 7, 16])[:B]
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    return ids, mask


def jax_loss_fn(model):
    """``loss_fn`` of ``__graft_entry__.dryrun_multichip``, as it is there."""

    def loss_fn(params, ids, mask):
        emb = model.apply(params, ids, mask)
        logits = emb @ emb.T * 20.0
        labels = jnp.arange(emb.shape[0])
        logits = logits - 1e9 * jnp.eye(emb.shape[0])
        pos = labels ^ 1
        return optax.softmax_cross_entropy_with_integer_labels(logits, pos).mean()

    return loss_fn


@pytest.fixture(scope="module")
def reference():
    """The flax parameters, and JAX's loss and gradients, on the ragged
    batch and on the reference's all-ones batch."""
    model = JaxEncoder(jax_cfg())
    ids, mask = batch()
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids[:1]), jnp.asarray(mask[:1]))
    params = jax.tree.map(np.asarray, params)
    value_and_grad = jax.jit(jax.value_and_grad(jax_loss_fn(model)))
    out = {"model": model, "params": params, "value_and_grad": value_and_grad}
    for name, (i, m) in {"ragged": (ids, mask), "ones": (np.ones((4, 16), np.int32),) * 2}.items():
        loss, grads = value_and_grad(params, jnp.asarray(i), jnp.asarray(m))
        out[name] = (i, m, float(loss), jax.tree.map(np.asarray, grads))
    return out


def port_model(params) -> TextEncoderModel:
    model = TextEncoderModel(port_cfg(), device="cpu", seed=None)
    model.load_state_dict(state_dict_from_flax(params, port_cfg()))
    return model


def check_grads(model: TextEncoderModel, jax_grads) -> None:
    """Every gradient within ``1e-5 * max|g_jax| + 1e-8``.  The key biases'
    exact gradient is 0 (the softmax is unchanged when q . b_k is added to
    every logit of a row), so both sides hold rounding noise of the sums
    that make the key weights' gradient: each is held to 1e-5 of that
    gradient's largest entry (the noise is 2e-8 to 6e-8 on both, plain
    torch autograd's too)."""
    want = state_dict_from_flax(jax_grads, port_cfg())
    for name, p in model.named_parameters():
        g, ref = p.grad, want[name]
        assert g is not None, name
        if name.endswith("attention.key.bias"):
            noise = 1e-5 * float(want[name.replace(".bias", ".weight")].abs().max())
            assert float(g.abs().max()) <= noise and float(ref.abs().max()) <= noise, name
            continue
        bound = 1e-5 * float(ref.abs().max()) + 1e-8
        err = float((g - ref).abs().max())
        assert err <= bound, f"{name}: {err} > {bound}"


@pytest.mark.parametrize("case", ["ragged", "ones"])
def test_loss_and_every_gradient_match_jax(reference, case):
    ids, mask, jax_loss, jax_grads = reference[case]
    model = port_model(reference["params"])
    loss = train.contrastive_loss(model, torch.from_numpy(ids), torch.from_numpy(mask))
    assert abs(loss.item() - jax_loss) <= 1e-6 * abs(jax_loss)
    loss.backward()
    if case == "ragged":
        check_grads(model, jax_grads)
        return
    # the reference's all-ones batch: every row embeds the same, each row's
    # softmax is uniform over the others, G + G^T sums to 0 along every row,
    # so the exact gradient is 0 and both sides hold rounding noise: each
    # within 1e-5 of the ragged batch's gradient of the same tensor (1e-8 to
    # 1.5e-7 against 0.06 to 0.46 on both)
    assert abs(jax_loss - np.log(ids.shape[0] - 1)) <= 1e-6
    scale = state_dict_from_flax(reference["ragged"][3], port_cfg())
    want = state_dict_from_flax(jax_grads, port_cfg())
    for name, p in model.named_parameters():
        noise = 1e-5 * float(scale[name].abs().max())
        assert float(p.grad.abs().max()) <= noise and float(want[name].abs().max()) <= noise, name


def test_int16_ids_and_uint8_mask_give_the_same_gradients(reference):
    # the executor narrows ids to int16 and the mask to uint8: the table
    # scatter-add widens them
    ids, mask, _, jax_grads = reference["ragged"]
    model = port_model(reference["params"])
    train.contrastive_loss(model, torch.from_numpy(ids.astype(np.int16)),
                           torch.from_numpy(mask.astype(np.uint8))).backward()
    check_grads(model, jax_grads)


def test_adam_plain_matches_optax_over_three_steps(reference):
    ids, mask, _, _ = reference["ragged"]
    params = reference["params"]
    opt = optax.adam(LR)
    state = opt.init(params)
    jp = params
    model = port_model(params)
    adam = train.Adam(model.named_parameters(), lr=LR)
    for step in range(3):
        _, grads = reference["value_and_grad"](jp, jnp.asarray(ids), jnp.asarray(mask))
        grads = jax.tree.map(np.asarray, grads)
        updates, state = opt.update(grads, state, jp)
        jp = jax.tree.map(np.asarray, optax.apply_updates(jp, updates))
        # the same (JAX's) gradients into K19's plain version
        for name, g in state_dict_from_flax(grads, port_cfg()).items():
            model.get_parameter(name).grad = g
        adam.step()
        adam.zero_grad()
    want = state_dict_from_flax(jp, port_cfg())
    for name, p in model.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= 1e-7, f"{name}: {err}"
    mine = adam.state_dict()
    theirs = adam_state_from_optax(state, port_cfg())
    assert mine["count"] == theirs["count"] == 3
    for key in ("mu", "nu"):
        for name, t in mine[key].items():
            scale = float(theirs[key][name].abs().max()) + 1e-30
            assert float((t - theirs[key][name]).abs().max()) <= 1e-6 * scale, (key, name)
    # and back: the port's state as an optax state gives optax's next update
    back = adam_state_to_optax(mine, state)
    _, grads = reference["value_and_grad"](jp, jnp.asarray(ids), jnp.asarray(mask))
    u1, _ = opt.update(grads, state, jp)
    u2, _ = opt.update(grads, back, jp)
    for a, b in zip(jax.tree.leaves(u1), jax.tree.leaves(u2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-12)


def test_state_dict_to_flax_inverts_state_dict_from_flax(reference):
    params = reference["params"]
    back = state_dict_to_flax(state_dict_from_flax(params, port_cfg()), params)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_one_train_step_matches_jax(reference):
    ids, mask, _, jax_grads = reference["ragged"]
    params = reference["params"]
    opt = optax.adam(LR)
    state = opt.init(params)
    updates, _ = opt.update(jax_grads, state, params)
    want = state_dict_from_flax(jax.tree.map(np.asarray, optax.apply_updates(params, updates)), port_cfg())
    g_jax = state_dict_from_flax(jax_grads, port_cfg())
    model = port_model(params)
    adam = train.Adam(model.named_parameters(), lr=LR)
    loss = train.train_step(model, adam, torch.from_numpy(ids), torch.from_numpy(mask))
    assert abs(float(loss) - reference["ragged"][2]) <= 1e-6 * abs(reference["ragged"][2])
    for name, p in model.named_parameters():
        err = (p.detach() - want[name]).abs()
        assert float(err.max()) <= 2 * LR, name
        if name.endswith("attention.key.bias"):
            continue  # its gradient is rounding noise on both sides (check_grads)
        big = g_jax[name].abs() >= 1e-4 * float(g_jax[name].abs().max())
        assert float(err[big].max()) <= 1e-2 * LR, name


def test_step_on_a_data_and_model_mesh_matches_one_device(reference):
    ids, mask, _, _ = reference["ragged"]
    ids, mask = torch.from_numpy(ids[:4]), torch.from_numpy(mask[:4])
    one = port_model(reference["params"])
    opt1 = train.Adam(train.trainable(one), lr=LR)
    meshed = port_model(reference["params"])
    mesh = make_mesh({"data": 2, "model": 2}, ["cpu"] * 4)
    opt2 = train.Adam(train.trainable(meshed, mesh), lr=LR)
    for _ in range(2):
        l1 = train.train_step(one, opt1, ids, mask)
        l2 = train.train_step(meshed, opt2, ids, mask, mesh)
        # the shards' partial products sum in another order; the logits'
        # x20 carries the embeddings' f32 differences into the loss
        assert abs(float(l1) - float(l2)) <= 1e-5 * abs(float(l1))
    # the steps left the host copy the shards were cut from as it was;
    # state_dict gathers the shards into it
    stale = {name: p.detach().clone() for name, p in meshed.named_parameters()}
    got = meshed.state_dict()
    for name, p in one.named_parameters():
        # the key biases' gradient is rounding noise (check_grads), which
        # Adam turns into steps of up to lr of either sign
        bound = 2 * 2 * LR if name.endswith("attention.key.bias") else 1e-6
        assert float((got[name] - p.detach()).abs().max()) <= bound, name
        assert float((meshed.get_parameter(name).detach() - got[name]).abs().max()) == 0.0, name
    assert any(float((stale[n] - got[n]).abs().max()) > 0 for n in stale)
    # a model loaded from it runs as the meshed one does
    again = port_model(reference["params"])
    again.load_state_dict(got)
    with torch.no_grad():
        assert float((again(ids, mask) - meshed(ids, mask)).abs().max()) <= 1e-6


def test_data_replicas_on_distinct_devices_sum_their_gradients(reference):
    # two "devices" that are distinct objects of one grid shape: a mesh of
    # ["cpu", "cpu:0"] would resolve both to the CPU, so the replicas are
    # made by hand here by giving each data part its own model
    ids, mask, _, _ = reference["ragged"]
    ids, mask = torch.from_numpy(ids[:4]), torch.from_numpy(mask[:4])
    one = port_model(reference["params"])
    one_loss = train.contrastive_loss(one, ids, mask)
    one_loss.backward()
    a, b = port_model(reference["params"]), port_model(reference["params"])
    emb = torch.cat([a(ids[:2], mask[:2]), b(ids[2:], mask[2:])])
    in_batch_loss(emb).backward()
    for (name, p1), pa, pb in zip(one.named_parameters(), a.parameters(), b.parameters()):
        total = pa.grad + pb.grad
        assert float((total - p1.grad).abs().max()) <= 1e-6 * float(p1.grad.abs().max()) + 1e-9, name


def test_odd_batch_raises():
    with pytest.raises(ValueError, match="even"):
        contrastive_loss_plain(torch.zeros((5, 5)))


def test_contrastive_loss_gradient_is_autograds_in_f64():
    raw = torch.from_numpy(np.random.default_rng(1).normal(size=(6, 6))).requires_grad_()
    loss, grad = contrastive_loss_plain(raw)
    (auto,) = torch.autograd.grad(loss, raw)
    torch.testing.assert_close(grad, auto, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(lambda r: contrastive_loss_plain(r)[0], (raw,))


# ---------------------------------------------------------------------------
# each Function's backward against autograd of its plain version (f32: the
# plain versions compute in f32, as the kernels do)


def _assert_grads(got, want, rel=2e-5):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        bound = rel * float(w.abs().max()) + 1e-7
        assert float((g - w).abs().max()) <= bound


def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("D", [16, 32, 64, 80])
def test_attention_function_backward(D):
    B, L, H = 3, 70, 2
    q, k, v = (_rand(B, L, H, D, seed=s).requires_grad_() for s in range(3))
    mask = torch.ones((B, L), dtype=torch.uint8)
    mask[0, 40:] = 0
    mask[1, 3:66] = 0  # present keys in the first and last tiles only
    mask[2] = 0  # no present key: the uniform average, and its gradient
    dout = _rand(B, L, H, D, seed=5)
    got = torch.autograd.grad(AttentionFunction.apply(q, k, v, mask), (q, k, v), dout)
    want = torch.autograd.grad(attention_plain(q, k, v, mask), (q, k, v), dout)
    _assert_grads(got, want)


@pytest.mark.parametrize("act", ["none", "gelu_tanh", "gelu_erf", "tanh"])
def test_bias_act_function_backward(act):
    y, bias = _rand(5, 7, 24, seed=1).requires_grad_(), _rand(24, seed=2).requires_grad_()
    dout = _rand(5, 7, 24, seed=3)
    got = torch.autograd.grad(BiasActFunction.apply(y.clone(), bias, act), (y, bias), dout)
    # bias_act_plain updates y in place; autograd of the same f32 arithmetic
    # out of place
    want = torch.autograd.grad(_activate(y + bias, act), (y, bias), dout)
    torch.testing.assert_close(bias_act_plain(y.detach().clone(), bias.detach(), act), _activate(y + bias, act))
    _assert_grads(got, want)


def test_add_layer_norm_function_backward():
    x, r = _rand(4, 9, 32, seed=1).requires_grad_(), _rand(4, 9, 32, seed=2).requires_grad_()
    g, b = (1 + 0.1 * _rand(32, seed=3)).requires_grad_(), _rand(32, seed=4).requires_grad_()
    dout = _rand(4, 9, 32, seed=5)
    got = torch.autograd.grad(AddLayerNormFunction.apply(x, r, g, b, 1e-12), (x, r, g, b), dout)
    want = torch.autograd.grad(add_layer_norm_plain(x, r, g, b, 1e-12), (x, r, g, b), dout)
    _assert_grads(got, want)


@pytest.mark.parametrize("types", [False, True])
def test_embed_ln_function_backward(types):
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(-5, 40, (3, 8))).to(torch.int16)  # negatives wrap
    tids = torch.from_numpy(rng.integers(0, 2, (3, 8))).to(torch.uint8) if types else None
    word, pos = _rand(40, 16, seed=1).requires_grad_(), _rand(20, 16, seed=2).requires_grad_()
    ttab = _rand(2, 16, seed=3).requires_grad_()
    g, b = (1 + 0.1 * _rand(16, seed=4)).requires_grad_(), _rand(16, seed=5).requires_grad_()
    dout = _rand(3, 8, 16, seed=6)
    pos_view = pos[4:]  # a block of a longer sequence reads the table from its offset
    args = (ids, tids, word, pos_view, ttab, g, b, 1e-12, torch.float32)
    got = torch.autograd.grad(EmbedLnFunction.apply(*args), (word, pos, ttab, g, b), dout)
    want = torch.autograd.grad(embed_ln_plain(*args), (word, pos, ttab, g, b), dout)
    _assert_grads(got, want)


@pytest.mark.parametrize("types", [False, True])
def test_embed_ln_function_backward_all_ones_ids_matches_jax(types):
    """The reference train step's all-ones ids (every row gathers word row
    1: the repeated id K17 adds once per run) against JAX's gradient of
    ``Embeddings``: the word, position and type tables and the LayerNorm's
    scale and bias."""
    from pathway_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
    from pathway_tpu.models.encoder import Embeddings as JaxEmbeddings

    rng = np.random.default_rng(3)
    cfg = JaxEncoderConfig(vocab_size=40, hidden=16, max_len=20, type_vocab=2, dtype=jnp.float32)
    ids = np.ones((3, 8), dtype=np.int32)
    tids = rng.integers(0, 2, (3, 8)).astype(np.int32) if types else None
    module = JaxEmbeddings(cfg)
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(ids), None)["params"]
    params = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape), a.dtype), params)
    dout = rng.standard_normal((3, 8, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: module.apply({"params": p}, jnp.asarray(ids), None if tids is None else jnp.asarray(tids)),
                     params)
    (g,) = vjp(jnp.asarray(dout))
    want = [torch.from_numpy(np.array(a)) for a in (
        g["word"]["embedding"], g["position"]["embedding"], g["type"]["embedding"], g["ln"]["scale"], g["ln"]["bias"])]
    tables = [torch.from_numpy(np.array(a)).requires_grad_() for a in (
        params["word"]["embedding"], params["position"]["embedding"], params["type"]["embedding"],
        params["ln"]["scale"], params["ln"]["bias"])]
    word, pos, ttab, scale, bias = tables
    out = EmbedLnFunction.apply(torch.from_numpy(ids).to(torch.int16),
                                None if tids is None else torch.from_numpy(tids).to(torch.uint8),
                                word, pos, ttab, scale, bias, cfg.ln_eps, torch.float32)
    got = torch.autograd.grad(out, tables, torch.from_numpy(dout))
    _assert_grads(got, want)


@pytest.mark.parametrize("pool", ["cls", "mean"])
@pytest.mark.parametrize("normalize", [True, False])
def test_pool_normalize_function_backward(pool, normalize):
    x = _rand(4, 6, 16, seed=1).requires_grad_()
    # a fully masked row pools to 0 for the mean, where the norm's autograd
    # is NaN (sqrt at 0) and the kernel takes the clamp's branch, g / 1e-12
    empty = [0] * 6 if pool == "cls" else [0] * 5 + [1]
    mask = torch.tensor([[1] * 6, [1, 1, 0, 0, 0, 0], empty, [1, 0, 1, 0, 1, 0]], dtype=torch.uint8)
    dout = _rand(4, 16, seed=2)
    got = torch.autograd.grad(PoolNormalizeFunction.apply(x, mask, pool, normalize), (x,), dout)
    want = torch.autograd.grad(pool_normalize_plain(x, mask, pool, normalize), (x,), dout)
    _assert_grads(got, want)


def test_bf16_backward_raises():
    y = torch.zeros((2, 8), dtype=torch.bfloat16, requires_grad=True)
    out = BiasActFunction.apply(y.clone(), torch.zeros(8), "gelu_tanh")
    with pytest.raises(NotImplementedError, match="bf16"):
        out.float().sum().backward()


def test_inference_mode_takes_the_in_place_path(reference):
    # under inference_mode (the executor) no Function runs: the kernels as
    # before, and the same embeddings as with grad enabled
    ids, mask, _, _ = reference["ragged"]
    model = port_model(reference["params"])
    with torch.inference_mode():
        a = model(torch.from_numpy(ids), torch.from_numpy(mask))
    b = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert b.grad_fn is not None and a.grad_fn is None
    torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


def test_entry_and_dryrun_on_the_cpu(capsys):
    forward, (model, ids, mask) = train.entry(device="cpu")
    assert tuple(ids.shape) == (8, 128) and model.cfg.hidden == 768
    out = train.dryrun_multichip(4, device="cpu")
    assert out["mesh"] == {"data": 2, "model": 2} and np.isfinite(out["loss"])
    assert out["knn_hits"] == [2, 3, 4, 5] and out["long_doc_ring_err"] <= 1e-4
    assert "dryrun_multichip OK" in capsys.readouterr().out


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    names = [m.name for m in pkgutil.walk_packages(pathway_tpu_torch.__path__, "pathway_tpu_torch.")]
    assert "pathway_tpu_torch.train" in names
    assert {"pathway_tpu_torch.persistence", "pathway_tpu_torch.testing", "pathway_tpu_torch.testing.chaos"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}: importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'pathway_tpu'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_backward_wrappers_raise_instead_of_falling_back():
    """A tensor that is not on the CPU and not on a card (``meta``) makes
    each new wrapper raise; none runs its plain version for it."""
    from pathway_tpu_torch import kernels

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    q, m8 = meta(2, 16, 2, 16), meta(2, 16, dtype=torch.uint8)
    calls = [
        lambda: kernels.attention_bwd(q, q, q, q, q, m8, meta(2, 2, 16)),
        lambda: kernels.bias_act_bwd(meta(4, 16), meta(4, 16), meta(16), "gelu_tanh"),
        lambda: kernels.layer_norm_bwd(meta(4, 16), meta(4, 16), meta(4, 16), meta(16), 1e-12),
        lambda: kernels.embed_ln_bwd(meta(2, 4, 16), meta(2, 4, dtype=torch.int32), None, meta(10, 16),
                                     meta(8, 16), None, meta(16), 1e-12),
        lambda: kernels.contrastive_loss(meta(4, 4)),
        lambda: kernels.pool_normalize_bwd(meta(2, 4, 16), meta(2, 4, dtype=torch.uint8), meta(2, 16), "cls", True),
        lambda: kernels.adam_step([meta(4)], [meta(4)], [meta(4)], [meta(4)], 1, 1e-4),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
