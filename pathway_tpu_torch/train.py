"""The contrastive train step and the entry points of
``__graft_entry__.py``, the port's counterparts of both.

- :func:`contrastive_loss`: the in-batch loss of ``loss_fn``
  (``__graft_entry__.py:117-124``): the encoder's L2-normalised
  embeddings, ``emb @ emb.T * 20`` with each row's own logit masked, and
  softmax cross-entropy against each row's pair partner (``i ^ 1``),
  averaged (K18 between the two dense products).
- :class:`Adam`: ``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root
  0, bias corrections on an int step count), one launch of K19 over every
  parameter.
- :func:`train_step`: ``jax.value_and_grad`` of the loss, then the Adam
  step; the backward runs through the kernels' autograd Functions (K15-K18)
  and the dense products' autograd.  Returns the loss.  With ``mesh``
  (``{"data": n / mp, "model": mp}``) the batch is cut over ``"data"`` and
  the parameters by :func:`~pathway_tpu_torch.models.encoder_param_specs`
  over ``"model"``: each data part runs on its replica (one model per
  distinct device grid along ``"data"``, its model shards on the devices
  along ``"model"``), the embeddings are gathered on the first device for
  the loss, the replicas' gradients are summed on the first replica, the
  Adam step runs there shard by shard (the ``"model"`` shards stay apart),
  and the other replicas copy its parameters.  Cut into model shards, the
  model's host copy is brought up to date from them only when its
  ``state_dict`` is read: a step moves nothing to the host.  A mesh may
  repeat a device; parts that share a replica add their gradients into it.
- :func:`entry`: the BGE-base forward at ``[8, 128]``, as ``entry()``
  (``__graft_entry__.py:42-59``).
- :func:`dryrun_multichip`: ``dryrun_multichip()``'s steps on the port's
  mesh (``__graft_entry__.py:62-244``): one train step over ``{"data":
  n / mp, "model": mp}``, the sequence-parallel encoder against local
  attention with a ragged mask across blocks, and the sharded index's
  self-match.  The reference's ``dp_work_scaling`` assertion reads XLA's
  ``cost_analysis`` of the compiled program; eager PyTorch compiles no
  program to read, so the port neither computes nor prints it.

Everything runs on ``device`` (default ``"cuda"``; raises without a card).
Only f32 is trained (the tiny flagship config, or BGE-base widths with
``dtype=torch.float32``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.kernels.adam import adam_step
from pathway_tpu_torch.kernels.contrastive_loss import in_batch_loss
from pathway_tpu_torch.models.encoder import BGE_BASE, EncoderConfig, TextEncoderModel
from pathway_tpu_torch.parallel.mesh import Mesh, encoder_grids, make_mesh

__all__ = [
    "flagship_config", "contrastive_loss", "Adam", "trainable", "train_step", "entry", "dryrun_multichip",
]


def flagship_config(tiny: bool = False) -> EncoderConfig:
    """BGE-base, or the f32 tiny config of ``_flagship_config(tiny=True)``
    (``__graft_entry__.py:28-39``): hidden 64, 4 heads of 16, MLP 128, 2
    layers."""
    if not tiny:
        return BGE_BASE
    return dataclasses.replace(BGE_BASE, layers=2, hidden=64, heads=4, mlp_dim=128, dtype=torch.float32)


def contrastive_loss(model: TextEncoderModel, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``loss_fn``: the in-batch contrastive loss of ``model``'s embeddings
    (adjacent rows are positive pairs; B even), differentiable."""
    return in_batch_loss(model(ids, mask))


class Adam:
    """``optax.adam(lr)`` over ``params`` (tensors, or ``(name, tensor)``
    pairs whose names key :meth:`state_dict`), one K19 launch a step and
    device.  Parameters without a gradient at a step are left as they are.
    """

    def __init__(self, params: Iterable, lr: float = 1e-4):
        named = [p if isinstance(p, tuple) else (str(i), p) for i, p in enumerate(params)]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.lr = lr
        self.mu = [torch.zeros_like(p, memory_format=torch.contiguous_format) for p in self.params]
        self.nu = [torch.zeros_like(p, memory_format=torch.contiguous_format) for p in self.params]
        self.count = 0  # optax's int32 step count

    @torch.no_grad()
    def step(self) -> None:
        live = [i for i, p in enumerate(self.params) if p.grad is not None]
        self.count += 1
        adam_step([self.params[i] for i in live], [self.params[i].grad.contiguous() for i in live],
                  [self.mu[i] for i in live], [self.nu[i] for i in live], self.count, self.lr)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(zip(self.names, (m.clone() for m in self.mu))),
                "nu": dict(zip(self.names, (v.clone() for v in self.nu)))}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for name, m, v in zip(self.names, self.mu, self.nu):
            m.copy_(state["mu"][name])
            v.copy_(state["nu"][name])


# ---------------------------------------------------------------------------
# data and tensor parallelism


def _replicas(model: TextEncoderModel, mesh: Mesh) -> list[TextEncoderModel]:
    """The model per data part: ``model`` itself placed on the first grid
    along ``"data"``, a copy of it on each other distinct grid (parts on
    the same grid share its model); made once per model and mesh."""
    cached = model.__dict__.get("_train_replicas")
    if cached is not None and cached[0] is mesh:
        return cached[1]
    grids = encoder_grids(mesh, "data", user="train_step")
    home = torch.device("cpu") if len(grids[0][0]) > 1 else None
    model.place(grids[0])
    made = {tuple(map(tuple, grids[0])): model}
    for grid in grids[1:]:
        key = tuple(map(tuple, grid))
        if key not in made:
            rep = TextEncoderModel(model.cfg, device=home or grid[0][0], seed=None, grid=grid)
            rep.load_state_dict(model.state_dict())
            made[key] = rep
    replicas = [made[tuple(map(tuple, grid))] for grid in grids]
    model.__dict__["_train_replicas"] = (mesh, replicas)
    return replicas


def _shard_params(model: TextEncoderModel) -> list[tuple[str, torch.nn.Parameter]]:
    """The parameters a forward of ``model`` trains: its own, or over model
    shards each shard's, named ``shard{j}.<name>``."""
    cells = model.cells()[0]
    if len(cells) == 1 and cells[0] is model:
        return list(model.named_parameters())
    return [(f"shard{j}.{n}", p) for j, cell in enumerate(cells) for n, p in cell.named_parameters()]


def trainable(model: TextEncoderModel, mesh: Mesh | None = None) -> list[tuple[str, torch.nn.Parameter]]:
    """The named parameters :func:`train_step` updates, for :class:`Adam`:
    the model's own, or over ``mesh`` the first data replica's model
    shards (placing the model on the mesh)."""
    if mesh is None:
        return list(model.named_parameters())
    return _shard_params(_replicas(model, mesh)[0])


def train_step(
    model: TextEncoderModel, opt: Adam, ids: torch.Tensor, mask: torch.Tensor, mesh: Mesh | None = None
) -> torch.Tensor:
    """One contrastive Adam step (``train_step``, ``__graft_entry__.py:
    126-131``); ``opt`` is over :func:`trainable` ``(model, mesh)``.
    Returns the loss (before the step)."""
    if mesh is None:
        loss = contrastive_loss(model, ids, mask)
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss.detach()
    replicas = _replicas(model, mesh)
    n = len(replicas)
    if ids.shape[0] % n:
        raise ValueError(f"batch of {ids.shape[0]} rows does not cut into {n} data parts")
    first = model.device
    embs = [rep(i.to(rep.device), m.to(rep.device)).to(first)
            for rep, i, m in zip(replicas, ids.chunk(n), mask.chunk(n))]
    loss = in_batch_loss(torch.cat(embs))
    loss.backward()
    distinct = list({id(r): r for r in replicas}.values())
    with torch.no_grad():
        own = _shard_params(distinct[0])
        for rep in distinct[1:]:  # the data parts' gradients, summed on the first replica
            for (_, p0), (_, p) in zip(own, _shard_params(rep)):
                if p.grad is not None:
                    g = p.grad.to(p0.device)
                    p0.grad = g if p0.grad is None else p0.grad + g
        opt.step()
        for rep in distinct[1:]:
            for (_, p0), (_, p) in zip(own, _shard_params(rep)):
                p.copy_(p0)
                p.grad = None
        opt.zero_grad()
    model.mark_shards_trained()  # state_dict gathers the shards when asked
    return loss.detach()


# ---------------------------------------------------------------------------
# the entry points of __graft_entry__.py


def entry(device: str | torch.device = "cuda"):
    """``(forward, (model, ids, mask))``: the BGE-base forward on ``[8,
    128]`` all-ones ids and mask, seeded random weights (``entry()``,
    ``__graft_entry__.py:42-59``)."""
    dev = resolve_device(device)
    model = TextEncoderModel(flagship_config(), device=dev, seed=0).eval()
    ids = torch.ones((8, 128), dtype=torch.int32, device=dev)
    mask = torch.ones((8, 128), dtype=torch.int32, device=dev)

    def forward(model, ids, mask):
        with torch.inference_mode():
            return model(ids, mask)

    return forward, (model, ids, mask)


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> dict:
    """One train step over ``{"data": n / mp, "model": mp}`` (mp 2 when n
    is even), the sequence-parallel encoder against local attention, and
    the sharded index's self-match, on a mesh that names ``device``
    ``n_devices`` times (a mesh may repeat a device).  Prints the
    reference's line without ``dp_work_scaling`` and returns its numbers."""
    from pathway_tpu_torch.parallel.sharded_knn import ShardedKnnIndex

    devs = [resolve_device(device)] * n_devices
    mp = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh({"data": n_devices // mp, "model": mp}, devs)
    cfg = flagship_config(tiny=True)
    dp = mesh.shape["data"]
    batch, seq = 2 * dp, 16
    first = devs[0]
    model = TextEncoderModel(cfg, device=first, seed=0)
    opt = Adam(trainable(model, mesh), lr=1e-4)
    ids = torch.ones((batch, seq), dtype=torch.int32, device=first)
    mask = torch.ones((batch, seq), dtype=torch.int32, device=first)
    loss = float(train_step(model, opt, ids, mask, mesh))
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    # sequence parallelism through the model: ring attention in every
    # layer, against the local-attention twin on the same weights
    sp_cfg = dataclasses.replace(cfg, max_len=8 * dp)
    sp_model = TextEncoderModel(dataclasses.replace(sp_cfg, seq_mesh=mesh), device=first, seed=2)
    local = TextEncoderModel(sp_cfg, device=first, seed=2)
    n_sp = 8 * dp
    sp_ids = torch.ones((2, n_sp), dtype=torch.int32, device=first)
    sp_mask = torch.ones((2, n_sp), dtype=torch.int32)
    sp_mask[1, n_sp // 2 + 3:] = 0  # a ragged tail across the blocks
    sp_mask = sp_mask.to(first)
    with torch.inference_mode():
        ring_err = float((sp_model(sp_ids, sp_mask) - local(sp_ids, sp_mask)).abs().max())
    if not ring_err <= 1e-4:
        raise AssertionError(f"long-doc ring-attention model mismatch: {ring_err}")

    # the corpus-sharded index: upserts, a removal and a self-match
    idx = ShardedKnnIndex(cfg.hidden, metric="cos", capacity=256, mesh=mesh)
    vecs = np.random.default_rng(0).normal(size=(64, cfg.hidden)).astype(np.float32)
    idx.add([(int(i), vecs[i]) for i in range(64)])
    idx.remove([0, 1])
    res = idx.search(vecs[2:6], k=4)
    if res[0][0][0] != 2:
        raise AssertionError(f"sharded KNN self-match failed: {res[0][:2]}")
    hits = [r[0][0] for r in res]
    print(f"dryrun_multichip OK: mesh={dict(mesh.shape)} loss={loss:.4f} "
          f"long_doc_ring_err={ring_err:.2e} knn_hits={hits}")
    return {"mesh": dict(mesh.shape), "loss": loss, "long_doc_ring_err": ring_err, "knn_hits": hits}
