"""Multi-source UNISAL training (PyTorch).

Port of ``retargetvid_tpu/train/trainer.py`` (reference
``unisal/train.py:36-1711``):

- SGD momentum 0.9, lr 0.04, a staircase exponential decay (gamma 0.8 per
  epoch), global-norm gradient clip 2.0, weight decay 1e-4 (1e-5 and 0.1x
  lr for the backbone CNN), hand-rolled as in JAX (:func:`make_optimizer`);
- loss = 1*kld - 0.1*nss - 0.1*cc averaged over time then batch;
- image batches (static) freeze the RNN/post-RNN parameters; every batch
  trains only its own source's domain-specific parameters: gradient masks
  matched on the port's dotted names as JAX matches on its ``/`` paths;
- the multi-source interleaving of the reference, shuffled with numpy's
  ``default_rng(rng_seed)`` exactly as JAX does.

The model holds the parameters and BatchNorm statistics; the optimizer
state is a trace per parameter and a step count.  Weights and checkpoints
are written in the JAX package's pickle format (``convert.py``), so a run
directory of either package loads in the other.  Batches are put on the
trainer's device (``device=None`` means the GPU); every dropout mask is
drawn from the trainer's ``torch.Generator``.

Mesh training (``init_state(mesh=...)`` or ``fit(mesh=...)``; JAX's
contract: it computes what single-device training on the global batch
computes, up to the order of reductions).  One process per GPU, joined by
``torch.distributed`` (``parallel/distributed.py``), forms a (dp, sp, tp)
``parallel.mesh.Mesh``.  Every rank holds the whole host batch and keeps
its block (:meth:`Trainer._shard_batch`: B over dp, H over sp when sp
divides it, else whole frames on every sp rank); the model runs under a
``parallel/shard.py:ModelShard`` (row halos, column-parallel convs,
BatchNorm moments and loss sums reduced over the mesh).  A weight that
``param_shardings`` splits holds its rank's O/tp output channels, and so
does its momentum trace.  The step all-reduces the gradients over dp x sp
(one flat buffer; over dp alone when the rows are replicated), leaves the
tp-split ones local, clips by the norm of the whole gradient (the split
leaves' squares summed over tp, each replicated leaf counted once) and
reports global metrics.  Weights and checkpoints stay full JAX trees:
gathered over tp, written by rank 0, cut again on load.  ``score_model``
and ``run_inference`` run a full copy of the model (gathered weights) on
every rank.
"""

from __future__ import annotations

import json
import pickle
import shutil
from dataclasses import dataclass
from itertools import chain, zip_longest
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from retargetvid_tpu_torch.config import KwConfig
from retargetvid_tpu_torch.convert import (
    flax_param_tree,
    flax_to_state_dict,
    load_flax_variables,
    shard_entries,
    state_dict_to_flax,
)
from retargetvid_tpu_torch.device import resolve_device
from retargetvid_tpu_torch.models.init import seeded_init_
from retargetvid_tpu_torch.models.unisal import UNISAL
from retargetvid_tpu_torch.parallel import shard
from retargetvid_tpu_torch.parallel.collectives import (
    all_reduce,
    barrier,
    gather_over,
)
from retargetvid_tpu_torch.train.losses import loss_sequences

__all__ = ["TrainState", "make_optimizer", "make_train_step",
           "make_eval_step", "Trainer"]


@dataclass
class TrainState:
    """Optimizer state (``{'trace': {name: tensor}, 'count': int}``) and
    the step count; the parameters live in the model."""
    opt_state: dict
    step: int = 0


def _is_cnn(name: str) -> bool:
    return name.startswith('cnn.')


def _source_of(name: str, sources) -> Optional[str]:
    low = name.lower()
    for s in sources:
        if s.lower() in low:
            return s
    return None


class _SGD:
    """The reference's SGD recipe (``retargetvid_tpu/train/trainer.py:
    74-134``), per parameter, with the mask ``m`` applied to the gradients
    before the clip:

        g <- g * m;  g <- g * min(1, clip / max(||g||, 1e-12))
        g <- g + wd * p * m             (wd: 1e-5 CNN, 1e-4 rest)
        trace <- momentum * trace + g   (only where m is 1)
        p <- p - lr_t * factor * trace * m   (factor: 0.1 CNN)

    ``lr_t = lr * gamma ** floor(count / steps_per_epoch)``.  A parameter
    whose gradient is None (unused in the forward) has a zero gradient,
    as in JAX, and still decays and keeps momentum where its mask is 1.
    Masked parameters (m = 0) are skipped: their trace is frozen and they
    do not move.  The update runs as ``torch._foreach_*`` calls, one group
    for the backbone and one for the rest.
    """

    def __init__(self, *, lr, momentum, lr_gamma, steps_per_epoch,
                 weight_decay, cnn_weight_decay, cnn_lr_factor, grad_clip):
        self.lr = lr
        self.momentum = momentum
        self.lr_gamma = lr_gamma
        self.steps_per_epoch = steps_per_epoch
        self.weight_decay = weight_decay
        self.cnn_weight_decay = cnn_weight_decay
        self.cnn_lr_factor = cnn_lr_factor
        self.grad_clip = grad_clip

    def lr_at(self, count: int) -> np.float32:
        """optax ``exponential_decay(staircase=True)`` in float32."""
        if count <= 0 or self.steps_per_epoch <= 0:
            return np.float32(self.lr)
        p = np.floor(np.float32(count) / np.float32(self.steps_per_epoch))
        return np.float32(self.lr) * np.power(np.float32(self.lr_gamma),
                                              np.float32(p))

    def init(self, params: dict) -> dict:
        return {'trace': {n: torch.zeros_like(p) for n, p in params.items()},
                'count': 0}

    @torch.no_grad()
    def update(self, params: dict, grads: dict, mask: dict,
               state: dict, tp_split=(), tp=None) -> dict:
        """Apply one step in place to ``params`` (name -> Parameter) with
        ``grads`` (name -> tensor or None) under ``mask`` (name -> 0/1);
        returns the new state (the traces are updated in place).  On a
        mesh, ``tp_split`` names the parameters split over the group
        ``tp``: the clip's norm sums their squares over it."""
        live = [n for n in params if mask[n] > 0]
        gs = [grads[n] if grads.get(n) is not None
              else torch.zeros_like(params[n]) for n in live]
        if not gs:
            return {'trace': state['trace'], 'count': state['count'] + 1}
        norms = torch._foreach_norm(gs)
        split = [i for i, n in enumerate(live) if n in tp_split]
        if tp is not None and tp.size > 1 and split:
            sq = torch.stack(norms) ** 2
            mine = torch.zeros_like(sq)
            mine[split] = sq[split]
            gnorm = torch.sqrt((sq - mine).sum()
                               + all_reduce(mine.sum(), tp))
        else:
            gnorm = torch.linalg.vector_norm(torch.stack(norms))
        scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        lr_t = self.lr_at(state['count'])
        for cnn in (True, False):
            idx = [i for i, n in enumerate(live) if _is_cnn(n) == cnn]
            if not idx:
                continue
            wd = self.cnn_weight_decay if cnn else self.weight_decay
            factor = self.cnn_lr_factor if cnn else 1.0
            ps = [params[live[i]] for i in idx]
            traces = [state['trace'][live[i]] for i in idx]
            g = torch._foreach_mul([gs[i] for i in idx], scale)
            torch._foreach_add_(g, torch._foreach_mul(ps, wd))
            torch._foreach_mul_(traces, self.momentum)
            torch._foreach_add_(traces, g)
            coef = float(np.float32(-lr_t) * np.float32(factor))
            torch._foreach_add_(ps, torch._foreach_mul(traces, coef))
        return {'trace': state['trace'], 'count': state['count'] + 1}


def make_optimizer(*, lr: float = 0.04, momentum: float = 0.9,
                   lr_gamma: float = 0.8, steps_per_epoch: int = 1000,
                   weight_decay: float = 1e-4, cnn_weight_decay: float = 1e-5,
                   cnn_lr_factor: float = 0.1, grad_clip: float = 2.0):
    """The hand-rolled SGD (see :class:`_SGD`): ``init(params)`` and
    ``update(params, grads, mask, state)``."""
    return _SGD(lr=lr, momentum=momentum, lr_gamma=lr_gamma,
                steps_per_epoch=steps_per_epoch, weight_decay=weight_decay,
                cnn_weight_decay=cnn_weight_decay,
                cnn_lr_factor=cnn_lr_factor, grad_clip=grad_clip)


def _grad_mask(names, *, source: str, static_batch: bool,
               train_cnn: bool, sources) -> dict:
    """1/0 per parameter name (reference ``train.py:375-386``): other
    sources' domain parameters, the RNN modules on static batches and,
    unless ``train_cnn``, the backbone are frozen."""

    def rule(name):
        src = _source_of(name, sources)
        if src is not None and src != source:
            return 0.0
        if static_batch and (name.startswith('rnn.') or
                             name.startswith('post_rnn.')):
            return 0.0
        if not train_cnn and _is_cnn(name):
            return 0.0
        return 1.0

    return {n: rule(n) for n in names}


def _summands(model, x, sal, fix, *, source, static, metrics, loss_weights,
              deterministic, generator):
    logp = model(x, source=source, static=static,
                 deterministic=deterministic, generator=generator)
    sharded = shard.current()
    mean = torch.mean if sharded is None else sharded.batch_mean
    summands = [mean(s) for s in loss_sequences(logp, sal, fix, metrics)]
    loss = sum(wt * s for wt, s in zip(loss_weights, summands))
    out = {'loss': loss}
    for name, val in zip(metrics, summands):
        out[name] = val
    return out


def make_train_step(model: UNISAL, tx, *, source: str,
                    loss_weights=(1.0, -0.1, -0.1),
                    metrics=('kld', 'nss', 'cc'),
                    static_batch: Optional[bool] = None,
                    train_cnn: bool = True,
                    sources=('DHF1K', 'Hollywood', 'UCFSports', 'SALICON'),
                    generator: Optional[torch.Generator] = None,
                    mesh=None, tp_split=()):
    """A train step for one source.

    step(state, x (B,T,H,W,3), sal (B,T,H,W,1), fix (B,T,H,W,1)) ->
    (state, {'loss', *metrics}: 0-d tensors).  The forward runs with
    dropout live (masks from ``generator``) and, where ``model.bn_train``,
    moves the BatchNorm statistics; only unmasked parameters take
    gradients.  With ``mesh`` the arrays are this rank's blocks and the
    step takes ``layout``, ``Trainer._layout`` of the global batch; the
    model's parameters named in ``tp_split`` hold their tp slices (see the
    module docstring).
    """
    params = dict(model.named_parameters())

    def step(state: TrainState, x, sal, fix, layout=None):
        static = x.shape[1] == 1 if static_batch is None else static_batch
        mask = _grad_mask(params, source=source, static_batch=static,
                          train_cnn=train_cnn, sources=sources)
        live = [n for n in params if mask[n] > 0]
        for n, p in params.items():
            p.requires_grad_(mask[n] > 0)
        sharded = None if mesh is None else shard.ModelShard(mesh, *layout)
        with shard.active(sharded):
            out = _summands(model, x, sal, fix, source=source,
                            static=static, metrics=metrics,
                            loss_weights=loss_weights, deterministic=False,
                            generator=generator)
            grads = torch.autograd.grad(
                out['loss'], [params[n] for n in live],
                allow_unused=True) if live else ()
        if sharded is not None:
            grads = _reduce_grads([g if g is not None else
                                   torch.zeros_like(params[n])
                                   for n, g in zip(live, grads)],
                                  sharded.stat)
        opt_state = tx.update(params, dict(zip(live, grads)), mask,
                              state.opt_state, tp_split=tp_split,
                              tp=None if sharded is None else sharded.tp)
        return (TrainState(opt_state, state.step + 1),
                {k: v.detach() for k, v in out.items()})

    return step


def _reduce_grads(grads: list, group) -> list:
    """The gradients summed over ``group`` in one all-reduce of a flat
    buffer."""
    if group.size == 1:
        return grads
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    return [f.view_as(g) for f, g in zip(
        flat.split([g.numel() for g in grads]), grads)]


def make_eval_step(model: UNISAL, *, source: str,
                   loss_weights=(1.0, -0.1, -0.1),
                   metrics=('kld', 'nss', 'cc'),
                   static_batch: Optional[bool] = None, mesh=None):
    """Forward-only loss evaluation with ``bn_train`` off and no dropout
    (the reference's valid phase, ``train.py:356-366``):
    step(x, sal, fix) -> {'loss', *metrics}; with ``mesh``,
    step(x, sal, fix, layout) on this rank's blocks, global metrics."""

    def step(x, sal, fix, layout=None):
        static = x.shape[1] == 1 if static_batch is None else static_batch
        sharded = None if mesh is None else shard.ModelShard(mesh, *layout)
        with torch.no_grad(), model.bn_mode(False), shard.active(sharded):
            return _summands(model, x, sal, fix, source=source,
                             static=static, metrics=metrics,
                             loss_weights=loss_weights, deterministic=True,
                             generator=None)

    return step


class Trainer(KwConfig):
    """Host-side training loop with the reference's multi-source schedule.

    ``Trainer.json`` holds exactly the JAX trainer's keys: ``device`` is
    runtime-only (``config_exclude``).
    """

    config_exclude = ('device',)

    def __init__(self, num_epochs=16, lr=0.04, momentum=0.9, lr_gamma=0.8,
                 weight_decay=1e-4, cnn_weight_decay=1e-5, grad_clip=2.0,
                 cnn_lr_factor=0.1, train_cnn_after=2,
                 loss_metrics=('kld', 'nss', 'cc'),
                 loss_weights=(1, -0.1, -0.1),
                 data_sources=('DHF1K', 'Hollywood', 'UCFSports', 'SALICON'),
                 salicon_weight=0.5, hollywood_weight=1.0,
                 ucfsports_weight=1.0,
                 steps_per_epoch=1000,
                 model_cfg=None, new_instance=True, device=None):
        self.num_epochs = num_epochs
        self.lr = lr
        self.momentum = momentum
        self.lr_gamma = lr_gamma
        self.weight_decay = weight_decay
        self.cnn_weight_decay = cnn_weight_decay
        self.grad_clip = grad_clip
        self.cnn_lr_factor = cnn_lr_factor
        self.train_cnn_after = train_cnn_after
        self.loss_metrics = tuple(loss_metrics)
        self.loss_weights = tuple(loss_weights)
        self.data_sources = tuple(data_sources)
        self.salicon_weight = salicon_weight
        self.hollywood_weight = hollywood_weight
        self.ucfsports_weight = ucfsports_weight
        self.steps_per_epoch = steps_per_epoch
        self.model_cfg = dict(model_cfg or {})
        self.new_instance = new_instance
        self.device = resolve_device(device)

        # Training mode: BN statistics update with the reference's momenta;
        # the backbone CNN stays in eval mode (cnn_eval, train.py:116-118).
        self.model = UNISAL(**{'bn_train': True, **self.model_cfg}).to(
            self.device)
        self.generator = torch.Generator(device=self.device)
        self._steps: dict = {}
        self.state: Optional[TrainState] = None
        self._tx = None
        #: The (dp, sp, tp) ``parallel.mesh.Mesh`` of mesh training (set by
        #: ``fit(mesh=...)`` / ``init_state(mesh=...)``); runtime-only.
        self.mesh = None
        #: Parameter name -> the dimension split over tp.
        self._tp_dims: dict = {}

        # Loop bookkeeping (reference train.py:190-205).
        self.epoch = 0
        self.best_epoch = 0
        self.best_val_score = None
        self.is_best = False
        self.history: list = []
        self.mit1003_finetuned = False

    # -- setup -----------------------------------------------------------
    def _params(self) -> dict:
        return dict(self.model.named_parameters())

    def _make_tx(self):
        return make_optimizer(
            lr=self.lr, momentum=self.momentum, lr_gamma=self.lr_gamma,
            steps_per_epoch=self.steps_per_epoch,
            weight_decay=self.weight_decay,
            cnn_weight_decay=self.cnn_weight_decay,
            cnn_lr_factor=self.cnn_lr_factor, grad_clip=self.grad_clip)

    def init_state(self, rng_seed: int = 0,
                   example_shape=(1, 1, 224, 416, 3),
                   variables: Optional[dict] = None, mesh=None,
                   tp_threshold: int = 256) -> TrainState:
        """Seed the model's weights (or adopt the JAX trees
        ``variables``) and create the optimizer state.

        With ``mesh`` (or a mesh set before), every rank builds the same
        full model, then keeps its tp slice of each weight that
        ``parallel.mesh.param_shardings`` splits at ``tp_threshold``; the
        momentum traces start as zeros of those slices.  ``example_shape``
        is JAX's signature: the port's modules know their shapes.
        """
        if mesh is not None:
            self._use_mesh(mesh)
        if self._tp_dims:                     # start from a full model
            self.model = UNISAL(**{'bn_train': True, **self.model_cfg}).to(
                self.device)
            self._tp_dims = {}
        self._steps = {}
        if variables is None:
            seeded_init_(self.model, rng_seed)
        else:
            load_flax_variables(self.model, variables)
        if self.mesh is not None and self.mesh.shape['tp'] > 1:
            from retargetvid_tpu_torch.parallel.mesh import param_shardings
            dims = param_shardings(self.mesh, self._params(),
                                   tp_threshold=tp_threshold)
            self._tp_dims = {n: d for n, d in dims.items() if d is not None}
            params = self._params()
            for name, (dim, index, parts) in self._tp_spec().items():
                n = params[name].shape[dim] // parts
                params[name].data = params[name].data.narrow(
                    dim, index * n, n).clone()
        self._tx = self._make_tx()
        self.state = TrainState(opt_state=self._tx.init(self._params()),
                                step=0)
        return self.state

    def _use_mesh(self, mesh) -> None:
        """Train on ``mesh``: its device becomes the trainer's, and its
        process groups form (every rank must get here)."""
        self.mesh = mesh
        if mesh.device != self.device:
            self.device = mesh.device
            self.model.to(self.device)
            self.generator = torch.Generator(device=self.device)
        if mesh.size > 1:
            _ = mesh.groups           # forms the process groups, all ranks

    def _tp_spec(self) -> dict:
        """Parameter name -> ``(dim, tp index, tp size)`` of the split
        ones (``convert.load_flax_variables``'s ``shards``)."""
        if not self._tp_dims:
            return {}
        tp, index = self.mesh.shape['tp'], self.mesh.coords['tp']
        return {n: (d, index, tp) for n, d in self._tp_dims.items()}

    def _full(self, values: dict) -> dict:
        """``values`` (parameter name -> tensor) with the tp-split ones
        gathered whole (a collective: every rank calls it)."""
        out = dict(values)
        for name, dim in self._tp_dims.items():
            if name in out:
                with torch.no_grad():
                    out[name] = gather_over(out[name].detach(), dim,
                                            self.mesh.groups['tp'])
        return out

    def _flax_tree(self) -> dict:
        """The model's full JAX trees (gathered over tp)."""
        return state_dict_to_flax(self.model, self._full(self._params()))

    @property
    def _writes(self) -> bool:
        """Whether this process writes the run's files (rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    def _written(self) -> None:
        """Every rank waits until rank 0 has written."""
        if self.mesh is not None and self.mesh.size > 1:
            barrier(self.mesh.groups['all'], self.device)

    def step_fn(self, source: str, static_batch: bool, train_cnn: bool):
        key = (source, static_batch, train_cnn)
        if key not in self._steps:
            self._steps[key] = make_train_step(
                self.model, self._tx, source=source,
                loss_weights=self.loss_weights, metrics=self.loss_metrics,
                static_batch=static_batch, train_cnn=train_cnn,
                sources=self.data_sources, generator=self.generator,
                mesh=self.mesh, tp_split=frozenset(self._tp_dims))
        return self._steps[key]

    def _batch(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device, torch.float32)

    def _rows_split(self, shape) -> bool:
        sp = self.mesh.shape['sp']
        return len(shape) >= 5 and sp > 1 and shape[2] % sp == 0

    def _layout(self, shape):
        """``(height, rows split)`` of a global batch of ``shape`` on the
        mesh (``None`` without one)."""
        if self.mesh is None:
            return None
        return int(shape[2]), self._rows_split(tuple(shape))

    def _shard_batch(self, arr) -> torch.Tensor:
        """This rank's block of one global batch array, on its device:
        B over dp, H over sp when sp divides it (else the sp ranks hold
        whole frames, as JAX replicates them)."""
        t = torch.as_tensor(arr)
        if self.mesh is None:
            return t.to(self.device, torch.float32)
        dp = self.mesh.shape['dp']
        if t.shape[0] % dp:
            raise ValueError(
                f'batch size {t.shape[0]} not divisible by the mesh dp '
                f'axis ({dp})')
        n = t.shape[0] // dp
        t = t[self.mesh.coords['dp'] * n:][:n]
        if self._rows_split(tuple(t.shape)):
            k = t.shape[2] // self.mesh.shape['sp']
            t = t[:, :, self.mesh.coords['sp'] * k:][:, :, :k]
        return t.to(self.device, torch.float32)

    def _shard_arrays(self, x, sal, fix):
        """The blocks of one (x, sal, fix) batch and its layout."""
        layout = self._layout(tuple(x.shape))
        return (*(self._shard_batch(a) for a in (x, sal, fix)), layout)

    def source_weight(self, source: str) -> float:
        return {'SALICON': self.salicon_weight,
                'Hollywood': self.hollywood_weight,
                'UCFSports': self.ucfsports_weight}.get(source, 1.0)

    # -- training --------------------------------------------------------
    def fit(self, dataloaders, train_dir, *, rng_seed: int = 0,
            chkpnt_warmup: int = 3, chkpnt_epochs: int = 2,
            shuffle_datasets: bool = True, mesh=None):
        """The reference's full training loop (``train.py:223-354``).

        ``dataloaders``: ``{source: {'train': factory, 'valid': factory}}``
        where each factory is a zero-arg callable returning an iterator of
        ``(x, sal, fix)`` batches and exposes ``n_batches`` (or supports
        ``len``).  Per epoch: the interleaved train phase and valid phase;
        after warmup, the DHF1K valid loss selects the best weights;
        checkpoints follow the reference's warmup/period rule; scalars
        export at the end.  Returns the best validation score
        (``-val_loss``).  With ``mesh`` the run is mesh training (see the
        module docstring); every rank calls ``fit`` with the same
        arguments, batches and seed, and rank 0 writes the files.
        """
        if mesh is not None:
            if self.state is not None and self.mesh is not mesh:
                raise ValueError('the trainer was initialized without this '
                                 'mesh: pass it to init_state')
            self._use_mesh(mesh)
        train_dir = Path(train_dir)
        train_dir.mkdir(parents=True, exist_ok=True)
        self.generator.manual_seed(rng_seed)
        pyrng = np.random.default_rng(rng_seed)

        n_train = sum(self._n_batches(dataloaders[s].get('train'))
                      for s in dataloaders)
        if self.state is None:
            self.steps_per_epoch = max(n_train, 1)
            self.init_state()
        if self._writes:
            self.save_cfg(train_dir)

        while self.epoch < self.num_epochs:
            self.fit_full_epoch(dataloaders, train_dir, pyrng,
                                chkpnt_warmup=chkpnt_warmup,
                                shuffle_datasets=shuffle_datasets)
            if (self.epoch >= chkpnt_warmup
                    and (self.epoch + 1) % chkpnt_epochs == 0) \
                    or self.epoch == self.num_epochs - 1:
                self.save_chkpnt(train_dir, self.epoch)
            self.epoch += 1

        if self._writes:
            self.export_scalars(train_dir, self.history)
        self._written()
        return self.best_val_score

    @staticmethod
    def _n_batches(factory) -> int:
        if factory is None:
            return 0
        n = getattr(factory, 'n_batches', None)
        if n is None:
            n = len(factory)
        return int(n)

    def _interleave(self, dataloaders, phase: str, pyrng,
                    shuffle_datasets: bool):
        """The reference's batch schedule (``train.py:278-287``): round-robin
        ``zip_longest`` over the sources' batch counts, then shuffled."""
        sources = [s for s in dataloaders if phase in dataloaders[s]]
        counts = {s: self._n_batches(dataloaders[s][phase]) for s in sources}
        schedule = [s for s in chain.from_iterable(zip_longest(
            *[[s] * counts[s] for s in sources])) if s is not None]
        if shuffle_datasets:
            pyrng.shuffle(schedule)
        iters = {s: iter(dataloaders[s][phase]()) for s in sources}
        return schedule, iters

    def fit_full_epoch(self, dataloaders, train_dir, pyrng, *,
                       chkpnt_warmup: int = 3, shuffle_datasets: bool = True):
        """One epoch = train phase + valid phase (reference ``fit_epoch``)."""
        epoch_scalars: dict = {}
        for phase in ('train', 'valid'):
            stats = self.fit_phase(dataloaders, phase, pyrng,
                                   shuffle_datasets=shuffle_datasets)
            for src, vals in stats.items():
                key = 'conv' if src == 'DHF1K' else src.lower()
                epoch_scalars[f'{key}/loss/{phase}'] = vals['loss']
                for name in self.loss_metrics:
                    epoch_scalars[f'{key}/{name}/{phase}'] = vals[name]
            # Best-weights selection on the DHF1K (or sole-source) valid
            # loss after warmup (reference train.py:340-354).
            sel_src = 'DHF1K' if 'DHF1K' in stats else \
                (list(stats)[0] if len(stats) == 1 else None)
            if phase == 'valid' and sel_src is not None and \
                    self.epoch >= chkpnt_warmup and sel_src in stats:
                val_score = -stats[sel_src]['loss']
                if self.best_val_score is None:
                    self.best_val_score = val_score
                elif val_score > self.best_val_score:
                    self.best_val_score = val_score
                    self.is_best = True
                    self.save_weights(train_dir, 'best')
                    if self._writes:
                        with open(Path(train_dir) / 'best_epoch.dat',
                                  'w') as fp:
                            fp.write(str(self.epoch))
                        with open(Path(train_dir) / 'best_val_loss.dat',
                                  'w') as fp:
                            fp.write(str(val_score))
                else:
                    self.is_best = False
        self.history.append(epoch_scalars)

    def fit_phase(self, dataloaders, phase: str, pyrng, *,
                  shuffle_datasets: bool = True) -> dict:
        """Run one train or valid phase over the interleaved schedule.

        Returns per-source mean metrics.  MIT1003 batches run under the
        SALICON domain (reference ``train.py:300``).
        """
        schedule, iters = self._interleave(dataloaders, phase, pyrng,
                                           shuffle_datasets)
        train_cnn = self.epoch >= self.train_cnn_after
        running: dict = {}
        counts: dict = {}
        for src in schedule:
            x, sal, fix, layout = self._shard_arrays(*next(iters[src]))
            model_src = 'SALICON' if src == 'MIT1003' else src
            static = x.shape[1] == 1
            if phase == 'train':
                step = self.step_fn(model_src, static, train_cnn)
                self.state, m = step(self.state, x, sal, fix, layout)
            else:
                m = make_eval_step(
                    self.model, source=model_src,
                    loss_weights=self.loss_weights,
                    metrics=self.loss_metrics, static_batch=static,
                    mesh=self.mesh)(x, sal, fix, layout)
            b = int(x.shape[0]) * (1 if self.mesh is None
                                   else self.mesh.shape['dp'])
            acc = running.setdefault(src, {k: 0.0 for k in m})
            for k, v in m.items():
                acc[k] += float(v) * b
            counts[src] = counts.get(src, 0) + b
        return {src: {k: v / counts[src] for k, v in acc.items()}
                for src, acc in running.items()}

    def fine_tune_mit(self, dataloaders, train_dir, *, lr: float = 0.01,
                      num_epochs: int = 8, lr_gamma: float = 0.8,
                      train_cnn_after: int = 0, rng_seed: int = 0):
        """MIT1003 fine-tuning for MIT300 submission (reference
        ``train.py:1326-1392``): kld-only loss, lr 0.01, best weights loaded
        first, best val tracked per epoch.

        ``dataloaders``: ``{'MIT1003': {'train': ..., 'valid': ...}}``.
        Returns ``(best_val, best_epoch)``.
        """
        self.lr = lr
        self.num_epochs = num_epochs
        self.lr_gamma = lr_gamma
        self.loss_weights = (1.0,)
        self.loss_metrics = ('kld',)
        self.data_sources = ('MIT1003',)
        self.train_cnn_after = train_cnn_after
        self.mit1003_finetuned = True
        self.epoch = 0

        train_dir = Path(train_dir)
        try:
            self.load_weights(train_dir / 'weights_best.pkl')
        except FileNotFoundError:
            pass                       # reference: fall back to last chkpnt

        n_train = self._n_batches(dataloaders['MIT1003'].get('train'))
        self.steps_per_epoch = max(n_train, 1)
        if self.state is None:
            self.init_state()
        else:                          # new optimizer recipe over old params
            self.reconfigure_optimizer()

        self.generator.manual_seed(rng_seed)
        pyrng = np.random.default_rng(rng_seed)
        best_epoch, best_val = None, None
        while self.epoch < self.num_epochs:
            stats = {}
            for phase in ('train', 'valid'):
                stats[phase] = self.fit_phase(dataloaders, phase, pyrng)
            val_loss = stats['valid'].get('MIT1003', {}).get(
                'loss', float('nan'))
            self.history.append({'mit1003/loss/train':
                                 stats['train'].get('MIT1003', {}).get(
                                     'loss', float('nan')),
                                 'mit1003/loss/valid': val_loss})
            if np.isnan(val_loss):     # reference train.py:1377-1380
                best_epoch, best_val = 0, 1000
                break
            val_score = -val_loss
            if self.best_val_score is None:
                self.best_val_score = val_score
            elif val_score > self.best_val_score:
                self.best_val_score = val_score
                best_epoch, best_val = self.epoch, val_loss
                self.save_weights(train_dir, 'best')
            self.epoch += 1
        if self._writes:
            self.export_scalars(train_dir, self.history)
        return best_val, best_epoch

    def reconfigure_optimizer(self):
        """Rebuild the optimizer (e.g. after fine-tune reconfig) keeping
        the current parameters; momentum/schedule state restarts."""
        self._tx = self._make_tx()
        self._steps = {}
        self.state = TrainState(opt_state=self._tx.init(self._params()),
                                step=self.state.step)

    # -- weights (reference model.py:26-49), the JAX package's format ------
    def save_weights(self, directory, name: str = 'best') -> Path:
        directory = Path(directory)
        path = directory / f'weights_{name}.pkl'
        tree = self._flax_tree()
        if self._writes:
            directory.mkdir(parents=True, exist_ok=True)
            with open(path, 'wb') as fp:
                pickle.dump(tree, fp)
        self._written()
        return path

    def load_weights(self, path):
        with open(path, 'rb') as fp:
            tree = pickle.load(fp)
        if self.state is None:
            self.init_state()
        load_flax_variables(self.model, tree, shards=self._tp_spec())
        return self.state

    def fit_epoch(self, batches, epoch: int) -> dict:
        """Run one epoch over an iterable of (source, x, sal, fix) batches."""
        train_cnn = epoch >= self.train_cnn_after
        totals: dict = {}
        count = 0
        for source, x, sal, fix in batches:
            x, sal, fix, layout = self._shard_arrays(x, sal, fix)
            step = self.step_fn(source, x.shape[1] == 1, train_cnn)
            self.state, m = step(self.state, x, sal, fix, layout)
            for k, v in m.items():
                totals[k] = totals.get(k, 0.0) + float(v) * \
                    self.source_weight(source)
            count += 1
        return {k: v / max(count, 1) for k, v in totals.items()}

    def full_model(self) -> UNISAL:
        """The model with every weight whole: the trainer's own, or after
        tp training a copy holding the gathered weights (a collective)."""
        if not self._tp_dims:
            return self.model
        model = UNISAL(**{'bn_train': True, **self.model_cfg}).to(
            self.device)
        return load_flax_variables(model, self._flax_tree())

    # -- evaluation (reference score_model, train.py:977-1075) ------------
    def score_model(self, batches, source: str = 'DHF1K',
                    metrics=('kld', 'nss', 'cc', 'sim', 'aucj')) -> dict:
        """Score held-out (x, sal, fix) batches with saliency metrics.

        kld/nss/cc run on the device; SIM and AUC-Judd use the numpy
        metrics (``eval/saliency_metrics.py``) on ``exp`` of the
        log-probabilities fetched to the host.
        """
        from retargetvid_tpu_torch.eval.saliency_metrics import auc_judd, sim

        dev_metrics = [m for m in metrics if m in ('kld', 'nss', 'cc')]
        totals: dict = {m: [] for m in metrics}
        model = self.full_model()
        for x, sal, fix in batches:
            x, sal_t, fix_t = (self._batch(a) for a in (x, sal, fix))
            with torch.no_grad(), model.bn_mode(False):
                logp = model(x, source=source, static=x.shape[1] == 1)
                dev = loss_sequences(logp, sal_t, fix_t, dev_metrics)
            for name, val in zip(dev_metrics, dev):
                totals[name].append(float(torch.mean(val)))
            if 'sim' in metrics or 'aucj' in metrics:
                pred = np.exp(logp.cpu().numpy())
                sal_np = sal_t.cpu().numpy()
                fix_np = fix_t.cpu().numpy()
                for b in range(pred.shape[0]):
                    for t in range(pred.shape[1]):
                        if 'sim' in metrics:
                            totals['sim'].append(
                                sim(pred[b, t, :, :, 0],
                                    sal_np[b, t, :, :, 0]))
                        if 'aucj' in metrics:
                            totals['aucj'].append(
                                auc_judd(pred[b, t, :, :, 0],
                                         fix_np[b, t, :, :, 0]))
        return {m: float(np.nanmean(v)) if v else float('nan')
                for m, v in totals.items()}

    def run_inference(self, frames, *, source: str = 'DHF1K',
                      frame_modulo: int = 4, seq_len: int = 6,
                      smooth_method=None, sal=None, fix=None,
                      metrics=('kld', 'nss', 'cc', 'sim', 'aucj')):
        """Whole-video recurrent inference + optional scoring (reference
        ``run_inference``, train.py:425-556).

        ``frames``: (T, H, W, 3) uint8.  With ``sal``/``fix`` targets
        ((T, H, W) float/binary), returns ``(maps, scores)``; otherwise
        ``(maps, None)``.  Dynamic sources run the interleaved frame-modulo
        recurrent scheme (one postprocess kernel launch per clip on the
        card); static sources (SALICON/MIT*) run per frame (one launch per
        32 frames).
        """
        from retargetvid_tpu_torch.eval.saliency_metrics import auc_judd, sim
        from retargetvid_tpu_torch.pipeline.saliency import SaliencyPredictor

        static = source in ('SALICON', 'MIT300', 'MIT1003')
        model = self.full_model()
        with model.bn_mode(False):
            predictor = SaliencyPredictor(model, source=source,
                                          device=self.device)
            if static:
                maps = predictor.predict(frames)
            else:
                maps = predictor.predict_video(
                    frames, source=source, frame_modulo=frame_modulo,
                    seq_len=seq_len, smooth_method=smooth_method)
        if sal is None and fix is None:
            return maps, None

        pred = maps.astype(np.float32)
        pred = pred / np.maximum(pred.sum(axis=(1, 2), keepdims=True), 1e-6)
        scores: dict = {}
        if sal is not None:
            sal = np.asarray(sal, np.float32)
            sal_n = sal / np.maximum(sal.sum(axis=(1, 2), keepdims=True),
                                     1e-6)
            if 'kld' in metrics:
                eps = 1e-7
                scores['kld'] = float(np.mean(np.sum(
                    sal_n * np.log(eps + sal_n / (pred + eps)),
                    axis=(1, 2))))
            if 'cc' in metrics:
                ccs = []
                for i in range(pred.shape[0]):
                    a, b = pred[i].ravel(), sal_n[i].ravel()
                    if a.std() > 0 and b.std() > 0:
                        ccs.append(float(np.corrcoef(a, b)[0, 1]))
                scores['cc'] = float(np.mean(ccs)) if ccs else float('nan')
            if 'sim' in metrics:
                scores['sim'] = float(np.mean(
                    [sim(pred[i], sal_n[i]) for i in range(pred.shape[0])]))
        if fix is not None:
            fixb = np.asarray(fix) > 0.5
            if 'nss' in metrics:
                vals = []
                for i in range(pred.shape[0]):
                    p = pred[i]
                    std = p.std()
                    if std > 0 and fixb[i].any():
                        z = (p - p.mean()) / std
                        vals.append(float(z[fixb[i]].mean()))
                scores['nss'] = float(np.mean(vals)) if vals else float('nan')
            if 'aucj' in metrics:
                scores['aucj'] = float(np.nanmean(
                    [auc_judd(pred[i], fixb[i].astype(np.float32))
                     for i in range(pred.shape[0])]))
        return maps, scores

    # -- checkpointing (reference train.py:1627-1650 equivalents) ---------
    def save_chkpnt(self, directory, epoch: int) -> Path:
        directory = Path(directory)
        path = directory / f'chkpnt_epoch{epoch:04d}.pkl'
        tree = self._flax_tree()
        tree['opt_state'] = {
            'trace': flax_param_tree(self.model, self._full(
                self.state.opt_state['trace'])),
            'count': np.asarray(self.state.opt_state['count'], np.int32)}
        tree['step'] = np.asarray(self.state.step, np.int32)
        if self._writes:
            directory.mkdir(parents=True, exist_ok=True)
            with open(path, 'wb') as fp:
                pickle.dump(tree, fp)
            self.save_cfg(directory)
        self._written()
        return path

    def load_chkpnt(self, path) -> TrainState:
        with open(path, 'rb') as fp:
            tree = pickle.load(fp)
        if self._tx is None:
            self.init_state()
        load_flax_variables(self.model, tree, shards=self._tp_spec())
        params = self._params()
        trace = shard_entries(flax_to_state_dict(
            {'params': tree['opt_state']['trace']}), self._tp_spec())
        if set(trace) != set(params):
            raise KeyError('checkpoint trace does not match the model')
        self.state = TrainState(
            opt_state={'trace': {n: trace[n].to(p.device, p.dtype)
                                 for n, p in params.items()},
                       'count': int(tree['opt_state']['count'])},
            step=int(tree['step']))
        return self.state

    def copy_code(self, directory) -> Path:
        """Archive the package's source next to the checkpoints
        (reference ``train.py:1597-1625``)."""
        import retargetvid_tpu_torch
        src = Path(retargetvid_tpu_torch.__file__).parent
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        dst = directory / 'code_copy'
        if dst.exists():
            shutil.rmtree(dst)
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns('__pycache__'))
        return dst

    def export_scalars(self, directory, history) -> Path:
        """Write the scalar history as ``all_scalars.json`` (reference's
        TensorboardX export, ``train.py:1652-1699``): per key, a list of
        ``[epoch, value]``."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        path = directory / 'all_scalars.json'
        scalars: dict = {}
        for epoch, metrics in enumerate(history):
            for k, v in metrics.items():
                scalars.setdefault(k, []).append([epoch, float(v)])
        with open(path, 'w') as fp:
            json.dump(scalars, fp, indent=2)
        return path
