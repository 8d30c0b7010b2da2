"""Entry path: ``parallel.runner.ShardedOneShot`` of ``retargetvid_tpu_torch``
over a dp mesh, one process per card: what ``cli benchmark --mesh N
--oneshot`` runs.

Rank 0 is the harness's own process, on ``cuda:0``.  It starts ranks 1 to
dp - 1 as spawned daemon processes, rank r on ``cuda:r``, and every rank
joins through ``parallel.distributed.initialize`` (NCCL on the cards, gloo
on the CPU) on a free local port, with a bounded timeout.  Each rank makes
the same seeded weights and clip pool on its own card, and rank 0 compares
their checksums.  A dispatch is one batch: the pool's ``clips_per_rank`` x
dp clips.  Rank 0 broadcasts the command over a gloo group, on the host;
every rank runs ``dispatch_batch`` on its block of the batch, one clip after
another, and ``collect_batch`` all-gathers the packed outputs.

In a traced run rank 0's ``StageTimer`` times each of its clips as
``OneShotClipProgram`` does (one clip per call of the clip body), since
``ShardedOneShot`` sets no timer of its own.

The check is ``crop_oneshot``'s, on the gathered outputs of the checked
clips, at least one of them computed off rank 0.  The rank that computes a
checked clip keeps the postprocess kernel's maps of it, batch by batch, and
sends them to rank 0 once the window has closed.  Every rank then reports
the modules of JAX or the JAX package it has loaded; any ends the run
without a result.

A rank that raises or ends, or a call into the ranks that waits longer than
``STALL_S``, ends the run without a result (exit code 2), every rank
stopped first.  A rank whose parent is gone ends itself.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import multiprocessing.connection
import os
import socket
import sys
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from portbench import core, inputs
from portbench.check import run_check
from portbench.paths import crop_oneshot
from portbench.reference import pipeline as ref

#: Seconds the rendezvous and every collective wait for the other ranks.
TIMEOUT_S = 120.0
#: Seconds rank 0 waits on one call into the ranks before it ends the run:
#: under ``TIMEOUT_S``, so that no collective's own timeout fires first.
STALL_S = 90.0
#: Commands rank 0 broadcasts, as the first of ``_WORDS`` int64 words.
STOP, RUN, CHECKED = 0, 1, 2
_WORDS = 16


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def seeded_models(cfg: dict, seed: int, device):
    """The program's TransNet and UNISAL on ``device`` with the seed's
    weights, as every rank makes them."""
    from retargetvid_tpu_torch.models.transnet import TransNetV1
    from retargetvid_tpu_torch.models.unisal import UNISAL
    t, u = cfg['transnet'], cfg['unisal']
    with torch.device(device):
        tn = TransNetV1(**crop_oneshot.tn_kwargs(cfg))
        un = UNISAL(cnn_widen_factor=u['cnn_widen_factor'])
    inputs.seed_weights_(tn, seed, 1, device,
                         {'dense2': t.get('head_bias', [0.0, 0.0])})
    inputs.seed_weights_(un, seed, 2, device)
    return tn, un


def draw_checked(rng, n: int, dp: int, k: int) -> list:
    """The ``n`` checked clips of a batch of dp x k, drawn from ``rng``:
    the first off rank 0's block."""
    first = int(rng.integers(k, dp * k))
    rest = [c for c in range(dp * k) if c != first]
    return sorted([first] + rng.choice(rest, size=n - 1,
                                       replace=False).tolist())


class Rank:
    """One rank's part: the seeded models in a ``ShardedOneShot`` on its
    card, the clip pool, and the postprocess kernel's maps of the checked
    clips that this rank computes, one per batch."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, rank: int,
                 init_method: str):
        from retargetvid_tpu_torch.parallel import distributed, runner
        from retargetvid_tpu_torch.parallel.mesh import make_mesh
        from retargetvid_tpu_torch.parallel.runner import ShardedOneShot
        from retargetvid_tpu_torch.pipeline import fused
        from retargetvid_tpu_torch.utils import timing
        self.dp, self.k = int(traffic['dp']), int(traffic['clips_per_rank'])
        self.rank, self.device = rank, device
        distributed.initialize(
            rank, self.dp, init_method,
            'nccl' if device.type == 'cuda' else 'gloo', timeout_s=TIMEOUT_S)
        if device.type == 'cuda':
            # NCCL builds its communicator at the first collective: here,
            # with the rendezvous, rather than inside the warm batch.
            dist.all_reduce(torch.zeros(1, device=device))
        self.control = dist.new_group(
            backend='gloo', timeout=datetime.timedelta(seconds=TIMEOUT_S))
        mesh = make_mesh(self.dp, (self.dp, 1, 1), device=device)
        t, u = cfg['transnet'], cfg['unisal']
        tn, un = seeded_models(cfg, seed, device)
        self.tn_state, self.un_state = inputs.state_of(tn), inputs.state_of(un)
        self.runner = ShardedOneShot(
            mesh, tn, un, source=u['source'],
            dtype=crop_oneshot._DTYPES[t['dtype']],
            tn_fullseq=t['plan'] == 'fullseq')
        fc, h, w = (int(traffic[k]) for k in ('frames', 'height', 'width'))
        self.pool = inputs.clip_pool(self.dp * self.k, fc, h, w, seed,
                                     device)
        self.cp = dict(cfg['crop_params'])
        self.fps = float(traffic['fps'])
        (self.w_final, self.h_final), = [ref.dest_size(w, h, r)
                                         for r in traffic['ratios']]
        self.block = range(rank * self.k, (rank + 1) * self.k)
        self.checked: list = []
        self.kept: dict = {}
        self.seq = 0
        self._maps: list = []
        self._fused, self._kernel = fused, fused.saliency_postprocess

        def kernel(logp):
            maps = self._kernel(logp)
            self._maps.append(maps)
            return maps
        fused.saliency_postprocess = kernel
        # Each call of the clip body is one clip of the timer (rank 0's, in
        # a traced run), as ``OneShotClipProgram`` makes its calls.
        self.timer = None
        self._runner, self._make_body = runner, runner.make_oneshot_body

        def make_body(*args, **kwargs):
            body = self._make_body(*args, **kwargs)

            def timed(*a, **kw):
                with timing.active(self.timer, device):
                    return body(*a, **kw)
            return timed
        runner.make_oneshot_body = make_body

    def checksums(self) -> list:
        """Every rank's float64 sums of its weights and clips, gathered on
        every rank."""
        parts = [*self.tn_state.values(), *self.un_state.values(), *self.pool]
        mine = torch.stack([p.to(self.device, torch.float64).sum()
                            for p in parts]).cpu()
        sums = [torch.empty_like(mine) for _ in range(self.dp)]
        dist.all_gather(sums, mine, group=self.control)
        return sums

    def send(self, *word) -> None:
        """Rank 0: broadcast a command to the other ranks."""
        t = torch.zeros(_WORDS, dtype=torch.int64)
        t[:len(word)] = torch.tensor(word, dtype=torch.int64)
        dist.broadcast(t, 0, group=self.control)

    def set_checked(self, checked) -> None:
        self.checked = sorted(int(c) for c in checked)
        self.kept = {c: [] for c in self.checked if c in self.block}

    def dispatch(self):
        """This rank's block of one batch up to its packed outputs; keeps
        the kernel's maps of the checked clips.  Returns (ticket, the
        batch's number)."""
        self._maps = []
        ticket = self.runner.dispatch_batch(
            self.pool, self.cp, fps=self.fps, w_final=self.w_final,
            h_final=self.h_final)
        if len(self._maps) != self.k:
            raise RuntimeError(f'{len(self._maps)} postprocess launches for '
                               f'{self.k} clips')
        for c, maps in zip(self.block, self._maps):
            if c in self.kept:
                self.kept[c].append(maps)
        self._maps = []
        seq, self.seq = self.seq, self.seq + 1
        return ticket, seq

    def serve(self) -> None:
        """Ranks 1 to dp - 1: follow rank 0's commands until STOP."""
        while True:
            word = torch.zeros(_WORDS, dtype=torch.int64)
            dist.broadcast(word, 0, group=self.control)
            cmd, *args = word.tolist()
            if cmd == RUN:
                self.runner.collect_batch(self.dispatch()[0])
            elif cmd == CHECKED:
                self.set_checked(args[1:1 + args[0]])
            elif cmd == STOP:
                return
            else:
                raise RuntimeError(f'unknown command {cmd}')

    def finish(self):
        """After STOP, on every rank: each rank's peak device memory and
        the forbidden modules it has loaded to all, then each checked
        clip's maps, by batch, from the rank that computed it to rank 0
        (over the mesh's backend).  Returns (peaks, forbidden modules by
        rank, {clip: maps indexable by batch number}) on rank 0."""
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == 'cuda' else 0)
        every = [None] * self.dp
        dist.all_gather_object(every, (peak, core.forbidden_modules()),
                               group=self.control)
        maps = {}
        for c in self.checked:
            owner = c // self.k
            if owner == 0:
                maps[c] = self.kept.get(c)
            elif self.rank == owner:
                stack = torch.stack(self.kept.pop(c))
                dist.send(torch.tensor(stack.shape, dtype=torch.int64), 0,
                          group=self.control)
                dist.send(stack, 0)
                del stack
            elif self.rank == 0:
                shape = torch.zeros(4, dtype=torch.int64)
                dist.recv(shape, owner, group=self.control)
                maps[c] = torch.empty(shape.tolist(), dtype=torch.uint8,
                                      device=self.device)
                dist.recv(maps[c], owner)
        return [int(p) for p, _ in every], [b for _, b in every], maps

    def close(self) -> None:
        from retargetvid_tpu_torch.parallel import distributed
        self._fused.saliency_postprocess = self._kernel
        self._runner.make_oneshot_body = self._make_body
        distributed.shutdown()


def _orphan_watch(parent: int) -> None:
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(3)


def _worker(cfg, traffic, seed, device_type, rank, init_method, parent):
    """Rank ``rank`` (1 to dp - 1): set up on its card, serve rank 0 until
    STOP.  An error ends the process at once with exit code 1."""
    threading.Thread(target=_orphan_watch, args=(parent,), daemon=True).start()
    try:
        torch.set_num_threads(2)
        device = torch.device('cpu')
        if device_type == 'cuda':
            device = torch.device('cuda', rank)
            torch.cuda.set_device(device)
        me = Rank(cfg, traffic, seed, device, rank, init_method)
        me.checksums()
        me.serve()
        me.finish()
        me.close()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


class Adapter(crop_oneshot.Adapter):
    """Rank 0: the cell's ranks, its dispatches, and ``crop_oneshot``'s
    check on the gathered outputs.  ``make_pool`` gives one item, the
    batch; ``frames_per_clip`` counts every frame of it."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self._settings(cfg, traffic, seed, device)
        self._peaks, self._checked_maps = [], {}
        self._lock = threading.Lock()
        self._closing = self._done = False
        self._since = None
        if device.type == 'cuda':
            # Once, here, before the ranks start and would each build.
            from retargetvid_tpu_torch.kernels.build import build_all
            build_all()
        init_method = f'tcp://127.0.0.1:{_free_port()}'
        # By import path, so that spawn can pickle it: the harness loads
        # this file under the same name without registering it.
        worker = importlib.import_module(__name__)._worker
        ctx = multiprocessing.get_context('spawn')
        self.procs = [ctx.Process(
            target=worker, name=f'rank {r}', daemon=True,
            args=(cfg, traffic, seed, device.type, r, init_method,
                  os.getpid())) for r in range(1, self.dp)]
        for p in self.procs:
            p.start()
        threading.Thread(target=self._watch, daemon=True).start()
        self.rank = self._call(Rank, cfg, traffic, seed, device, 0,
                               init_method)
        sums = self._call(self.rank.checksums)
        if any(not torch.equal(s, sums[0]) for s in sums[1:]):
            self._fatal('the ranks made different weights or clips')
        self.tn_state, self.un_state = self.rank.tn_state, self.rank.un_state
        self.program = self.rank.runner

    def _settings(self, cfg: dict, traffic: dict, seed: int, device):
        self.dp, k = int(traffic['dp']), int(traffic['clips_per_rank'])
        if cfg['unisal']['input_dtype'] != cfg['transnet']['dtype']:
            raise ValueError('ShardedOneShot feeds UNISAL in the TransNet '
                             'dtype; the configuration asks for two')
        if len(traffic['ratios']) != 1:
            raise ValueError('a batch is cropped at one ratio')
        if int(traffic['in_flight']) != 1:
            raise ValueError('the ranks follow one batch at a time')
        if not 1 <= int(traffic['check_clips']) <= min(self.dp * k,
                                                       _WORDS - 2):
            raise ValueError('check_clips out of range')
        self.cfg, self.seed, self.device = cfg, seed, device
        self.cp = dict(cfg['crop_params'])
        self.ratios = list(traffic['ratios'])
        self.fc = int(traffic['frames'])
        self.h, self.w = int(traffic['height']), int(traffic['width'])
        self.fps = float(traffic['fps'])
        self.frames_per_clip = self.dp * k * self.fc
        self.clips_on_card = k
        self.last_fc_sel = None
        self._geometry = {}

    # Failure handling: nothing may hang or outlive the run.

    def _stop_workers(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(10)

    def _fatal(self, why: str) -> None:
        print(f'portbench: {why}; the run ends without a result',
              file=sys.stderr, flush=True)
        self._stop_workers()
        os._exit(2)

    def _watch(self) -> None:
        sentinels = {p.sentinel: p for p in self.procs}
        while True:
            ended = multiprocessing.connection.wait(list(sentinels), 1.0)
            with self._lock:
                if self._done:
                    return
                closing = self._closing
            for s in ended:
                p = sentinels.pop(s)
                if not closing:
                    # Ended before STOP.  After it, ``release`` joins the
                    # ranks and reads their exit codes (one thread joins).
                    p.join(1.0)
                    self._fatal(f'{p.name} ended with exit code '
                                f'{p.exitcode}')
            since = self._since
            if since is not None and time.monotonic() - since > STALL_S:
                self._fatal(f'a call into the ranks waited over {STALL_S} s')

    def _call(self, fn, *args):
        """``fn(*args)``, watched: an error or a stall ends the run, since
        the ranks would no longer agree on what comes next."""
        self._since = time.monotonic()
        try:
            return fn(*args)
        except BaseException:
            traceback.print_exc()
            self._fatal(f'rank 0 failed in {getattr(fn, "__name__", fn)}')
        finally:
            self._since = None

    # The harness's interface.

    def make_pool(self, n: int) -> list:
        return [self.rank.pool]

    def checked_items(self, rng, n: int) -> list:
        """Draw the ``n`` checked clips from the seed, the first of them
        off rank 0's block, and tell every rank; the harness keeps the
        outputs of every batch (the pool's one item)."""
        checked = draw_checked(rng, n, self.dp, self.clips_on_card)
        self._call(self.rank.send, CHECKED, len(checked), *checked)
        self.rank.set_checked(checked)
        return [0]

    def set_timer(self, timer) -> None:
        self.rank.timer = timer

    def _dispatch(self):
        self.rank.send(RUN)
        return self.rank.dispatch()

    def dispatch(self, batch):
        return self._call(self._dispatch)

    def collect(self, ticket):
        ticket, seq = ticket
        outs = self._call(self.program.collect_batch, ticket)
        self.last_fc_sel = int(outs[0]['fc_sel'])
        return outs, seq

    def memory_peaks(self) -> list:
        return self._peaks

    def release(self) -> None:
        with self._lock:
            self._closing = True
        self._call(self.rank.send, STOP)
        self._peaks, bad, self._checked_maps = self._call(self.rank.finish)
        print(f'memory_peak_bytes by rank {self._peaks}', file=sys.stderr)
        if any(bad):
            self._fatal('modules of JAX or the JAX package are loaded: '
                        + '; '.join(f'rank {r}: {", ".join(b)}'
                                    for r, b in enumerate(bad) if b))
        # Every rank leaves the process group at once: NCCL's teardown
        # waits for all of a communicator's ranks.
        self._call(self.rank.close)
        for p in self.procs:
            p.join(STALL_S)
        with self._lock:
            self._done = True
        if any(p.exitcode != 0 for p in self.procs):
            self._fatal('ranks ended with exit codes '
                        f'{[p.exitcode for p in self.procs]}')
        self.program = self.rank.runner = None

    def check(self, outputs: dict, clips: list, control: bool = False):
        """Each checked clip's gathered outputs of every batch in the
        window, with its maps from that batch, against the reference on
        that clip."""
        (batch,) = clips
        by_clip = {c: [([outs[c]], self._checked_maps[c][seq])
                       for outs, seq in outputs[0]]
                   for c in self.rank.checked}
        return run_check(self, by_clip, [batch[c] for c in sorted(by_clip)],
                         control)


class ControlOnly(Adapter):
    """The check's side of a run alone, on one card: the seed's weights
    and the reference, no program and no ranks."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self._settings(cfg, traffic, seed, device)
        tn, un = seeded_models(cfg, seed, device)
        self.tn_state, self.un_state = inputs.state_of(tn), inputs.state_of(un)


def control_readings(cfg: dict, traffic: dict, seed: int, device,
                     every: bool = False) -> dict:
    """The control's readings, clip by clip, on the clips that a run of
    the cell with ``seed`` checks (``every``: on every clip of the batch),
    on one card: the control is the reference put in the program's place
    one clip at a time, and the mesh does not enter it.  Returns
    ``{clip: {'checked': bool, number: reading}}``."""
    judge = ControlOnly(cfg, traffic, seed, device)
    dp, k = judge.dp, judge.clips_on_card
    # As ``core.run`` draws them: the run's first use of its generator.
    rng = np.random.default_rng(seed % (2 ** 63))
    checked = draw_checked(rng, int(traffic['check_clips']), dp, k)
    pool = inputs.clip_pool(dp * k, judge.fc, judge.h, judge.w, seed, device)
    out = {}
    for c in (range(dp * k) if every else checked):
        got = run_check(judge, {c: []}, [pool[c]], control=True)
        out[c] = {'checked': c in checked,
                  **{n: r['control'] for n, r in got['readings'].items()}}
    return out
