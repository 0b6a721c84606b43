"""Host-offloaded AdamW: the Adam moments live in host memory — counterpart
of `unimoe_audio_tpu/train/offload.py`.

On-device AdamW keeps bf16 parameters, bf16 gradients and f32 moments on
the card: 12 bytes a parameter, about 78 GB for the 36-layer flagship
before any activation.  Here the moments (f32, or blockwise int8,
`train/qmoment.py`) sit in page-locked host memory and stream through the
card chunk by chunk during the update; the card holds the parameters, the
gradients and the chunks in flight (the reference's DeepSpeed ZeRO-2
`offload_optimizer: cpu`, deepspeed_zero2.conf:23-37).

Host memory (`HostArena`): one block per group of buffers, every buffer at
its exact size, page-locked once with cudaHostRegister and released by
`close()`.  torch's pinned allocations would round each buffer up to a
power of two and keep freed blocks cached across phases.

Copies (`Streamer`): host-to-device copies on one side stream and
device-to-host copies on another, non_blocking, ordered by CUDA events; the
next chunk's copy in overlaps the current chunk's update, and the host waits
one chunk behind so that the caching allocator does not queue every chunk
on the card.  A copy into host memory is complete only after its event:
every phase that writes host buffers ends with `Streamer.drain()` before
anything reads them.  On the CPU the copies are real copies, so the CPU
tests run the card's dataflow.

The moments are chunked per leaf along dim 0 by `chunk_bytes` of f32
(`_chunk_bounds`, the JAX package's function of the leaf's shape).  The
port's parameters are per-layer dicts, not `[L]`-stacked leaves, so a layer
leaf chunks over its own dim 0.

AdamW math is the JAX package's: global-norm clip, bias-corrected Adam,
decoupled weight decay under the no-decay mask (`step._decays`), the
schedule's lr at the pre-increment count.  A non-finite loss or gradient
norm skips the whole update (`"skipped": 1.0`).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..api import resolve_device
from ..config import UniMoEAudioConfig
from ..models.model import fold_seed
from .qmoment import BLOCK, dequantize_blockwise, padded_len, quantize_blockwise, rounding_key
from .step import (_decays, adamw_leaf, aux_weight_at_step, global_norm, loss_fn, named_leaves,
                   place_batch)

MOMENT_DTYPES = ("float32", "int8")


def _chunk_bounds(shape, chunk_bytes: int) -> List[Tuple[int, int]]:
    """Split dim 0 so that each chunk's f32 bytes stay under chunk_bytes."""
    if not shape:
        return [(0, 1)]
    nbytes = int(np.prod(shape)) * 4
    L = shape[0]
    n = int(min(L, max(1, -(-nbytes // chunk_bytes))))
    bounds = np.linspace(0, L, n + 1).astype(int)
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def _release(buf: torch.Tensor) -> None:
    torch.cuda.synchronize()
    rc = int(torch.cuda.cudart().cudaHostUnregister(buf.data_ptr()))
    if rc:
        raise RuntimeError(f"cudaHostUnregister failed with CUDA error {rc}")


class HostArena:
    """Host buffers of the given (shape, dtype) specs, carved from one
    zeroed block (256-byte aligned); page-locked when `device` is the card.
    `tensors` lists the buffers in spec order."""

    ALIGN = 256

    def __init__(self, specs: Sequence[Tuple[Tuple[int, ...], torch.dtype]], device):
        offsets, total = [], 0
        for shape, dtype in specs:
            offsets.append(total)
            nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
            total += -(-nbytes // self.ALIGN) * self.ALIGN
        self.nbytes = total
        buf = torch.zeros(total + self.ALIGN, dtype=torch.uint8)
        base = -buf.data_ptr() % self.ALIGN
        self._finalizer = None
        if torch.device(device).type == "cuda":
            rc = int(torch.cuda.cudart().cudaHostRegister(buf.data_ptr(), buf.numel(), 0))
            if rc:
                raise RuntimeError(f"cudaHostRegister of {total / 1e9:.2f} GB failed with CUDA "
                                   f"error {rc}")
            self._finalizer = weakref.finalize(self, _release, buf)
        self.tensors = []
        for off, (shape, dtype) in zip(offsets, specs):
            n = int(np.prod(shape))
            nbytes = n * torch.empty((), dtype=dtype).element_size()
            self.tensors.append(buf[base + off:base + off + nbytes].view(dtype).view(shape))

    def close(self) -> None:
        """Unregister the block (the card must be idle) and drop the
        buffers."""
        if self._finalizer is not None:
            self._finalizer()
        self.tensors = []


class Streamer:
    """Host↔device copies of one trainer.  On the card: `fetch` copies host
    buffers in on the h2d stream (after the compute stream's work so far,
    whose freed memory the copies may reuse); `ready` makes the compute
    stream wait for them; `store` copies device tensors out on the d2h
    stream once the compute stream has produced them.  On the CPU each is a
    plain copy."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.h2d = torch.cuda.Stream(self.device)
            self.d2h = torch.cuda.Stream(self.device)

    def fetch(self, hosts: Sequence[torch.Tensor]):
        if not self.cuda:
            return [h.clone() for h in hosts], None
        devs = [torch.empty(h.shape, dtype=h.dtype, device=self.device) for h in hosts]
        self.h2d.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.h2d):
            for d, h in zip(devs, hosts):
                d.copy_(h, non_blocking=True)
                d.record_stream(self.h2d)
            ev = torch.cuda.Event()
            ev.record(self.h2d)
        return devs, ev

    def ready(self, fetched) -> List[torch.Tensor]:
        devs, ev = fetched
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)
        return devs

    def store(self, devs: Sequence[torch.Tensor], hosts: Sequence[torch.Tensor]):
        """Copy devs into hosts; returns the copies' event (None on the CPU)."""
        if not self.cuda:
            for d, h in zip(devs, hosts):
                h.copy_(d)
            return None
        self.d2h.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.d2h):
            for d, h in zip(devs, hosts):
                h.copy_(d, non_blocking=True)
                d.record_stream(self.d2h)
            ev = torch.cuda.Event()
            ev.record(self.d2h)
        return ev

    def mark(self):
        """An event after the compute stream's work so far (None on the CPU)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    @staticmethod
    def wait(ev) -> None:
        """Block the host until `ev` (a `store` or `mark` event) is done."""
        if ev is not None:
            ev.synchronize()

    def drain(self) -> None:
        """Block the host until every copy issued so far is done."""
        if self.cuda:
            self.h2d.synchronize()
            self.d2h.synchronize()


# -- moments ---------------------------------------------------------------

def moment_specs(n: int, fmt: str) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
    """Host buffers of one moment vector of n values: f32 [n], or int8
    codes [n_pad] with absmax [n_pad / BLOCK]."""
    if fmt == "int8":
        npad = padded_len(n)
        return [((npad,), torch.uint8), ((npad // BLOCK,), torch.float32)]
    return [((n,), torch.float32)]


def moment_load(parts: Sequence[torch.Tensor], n: int, fmt: str, *, signed: bool) -> torch.Tensor:
    """A moment vector's device buffers → f32 [n] (for f32, the buffer
    itself, which the update then overwrites in place)."""
    if fmt == "int8":
        return dequantize_blockwise(parts[0], parts[1], signed=signed)[:n]
    return parts[0]


def moment_save(m: torch.Tensor, fmt: str, *, signed: bool, key) -> List[torch.Tensor]:
    """f32 [n] → the device tensors to store (int8: requantized with
    stochastic rounding under `key`)."""
    if fmt == "int8":
        n = m.numel()
        return list(quantize_blockwise(torch.nn.functional.pad(m, (0, padded_len(n) - n)),
                                       signed=signed, key=key))
    return [m]


@dataclass
class AdamStep:
    """The scalars of one update: the clip scale of the gradients (with its
    division by the micro-batch count, where they are sums), the
    schedule's lr and the post-increment count."""
    scale: float
    lr: float
    count: int
    b1: float
    b2: float
    eps: float

    def apply(self, p: torch.Tensor, g: Optional[torch.Tensor], m: torch.Tensor,
              v: torch.Tensor, wd: float) -> None:
        """p (any dtype; a flat view updated in place), g (None: zero),
        m and v (f32, flat, updated in place): `step.adamw_leaf`."""
        adamw_leaf(p, g, m, v, scale=self.scale, lr=self.lr, count=self.count, b1=self.b1,
                   b2=self.b2, eps=self.eps, wd=wd)


# -- the optimizer -----------------------------------------------------------

@dataclass
class OffloadState:
    params: Dict                                   # on the device
    mu: List[List[List[torch.Tensor]]]             # per leaf, per chunk: host buffers
    nu: List[List[List[torch.Tensor]]]
    count: int = 0                                 # applied updates
    step: int = 0
    arena: Optional[HostArena] = field(default=None, repr=False)
    streamer: Optional[Streamer] = field(default=None, repr=False)

    def close(self) -> None:
        if self.arena is not None:
            self.streamer.drain()
            self.mu = self.nu = []
            self.arena.close()
            self.arena = None


class OffloadAdamW:
    """AdamW with host-resident moments, streamed through the device chunk
    by chunk.  The JAX package's `precompile` (its update programs compiled
    ahead in a thread pool) has no counterpart: eager torch compiles
    nothing."""

    def __init__(self, *, learning_rate: Union[Callable[[int], float], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip: float = 1.0,
                 chunk_bytes: int = 512 << 20, moment_dtype: str = "float32"):
        if moment_dtype not in MOMENT_DTYPES:
            raise ValueError(f"moment_dtype must be float32|int8, got {moment_dtype}")
        self.lr = learning_rate if callable(learning_rate) else (lambda c: learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.chunk_bytes = chunk_bytes
        self.moment_format = moment_dtype

    def _chunk_sizes(self, p: torch.Tensor) -> List[int]:
        rest = int(np.prod(p.shape[1:])) if p.ndim > 1 else 1
        return [(b - a) * rest if p.ndim else 1 for a, b in _chunk_bounds(p.shape, self.chunk_bytes)]

    def init_state(self, params: Dict) -> OffloadState:
        """Zero moment chunks in one host arena; the parameters stay where
        they are (their device is the trainer's)."""
        leaves = [t for _, t in named_leaves(params)]
        device = leaves[0].device
        fmt = self.moment_format
        specs, layout = [], []
        for p in leaves:
            sizes = self._chunk_sizes(p)
            layout.append([len(moment_specs(n, fmt)) for n in sizes])
            for _ in range(2):                     # mu, then nu
                for n in sizes:
                    specs += moment_specs(n, fmt)
        arena = HostArena(specs, device)
        it = iter(arena.tensors)
        mu, nu = [], []
        for parts in layout:
            mu.append([[next(it) for _ in range(k)] for k in parts])
            nu.append([[next(it) for _ in range(k)] for k in parts])
        return OffloadState(params=params, mu=mu, nu=nu, arena=arena, streamer=Streamer(device))

    def step_scalars(self, count: int, grad_norm: float, divide: int = 1) -> AdamStep:
        """The update at pre-increment count `count` for gradients of norm
        grad_norm (sums over `divide` micro-batches)."""
        scale = min(1.0, self.grad_clip / max(float(grad_norm), 1e-12)) / divide
        return AdamStep(scale=scale, lr=float(self.lr(count)), count=count + 1,
                        b1=self.b1, b2=self.b2, eps=self.eps)

    @torch.no_grad()
    def apply(self, state: OffloadState, grads: List[Optional[torch.Tensor]],
              grad_norm: float) -> OffloadState:
        """One AdamW step, in place on state.params and the host moments.
        grads align with `named_leaves(state.params)` (None: zero) and are
        consumed: the list's entries are dropped as their leaves finish."""
        fmt, st = self.moment_format, state.streamer
        adam = self.step_scalars(state.count, grad_norm)
        jobs = []
        for i, (name, p) in enumerate(named_leaves(state.params)):
            wd = self.weight_decay if _decays(name) else 0.0
            for j, (a, b) in enumerate(_chunk_bounds(p.shape, self.chunk_bytes)):
                jobs.append((i, p, a, b, wd, state.mu[i][j], state.nu[i][j],
                             j == len(state.mu[i]) - 1))
        nxt = st.fetch(jobs[0][5] + jobs[0][6]) if jobs else None
        prev = None
        for c, (i, p, a, b, wd, mu_h, nu_h, last) in enumerate(jobs):
            devs = st.ready(nxt)
            if c + 1 < len(jobs):
                nxt = st.fetch(jobs[c + 1][5] + jobs[c + 1][6])
            k = len(mu_h)
            flat_p = p.view(-1) if p.ndim == 0 else p[a:b].view(-1)
            g = grads[i]
            flat_g = None if g is None else (g.view(-1) if g.ndim == 0 else g[a:b].reshape(-1))
            n = flat_p.numel()
            m = moment_load(devs[:k], n, fmt, signed=True)
            v = moment_load(devs[k:], n, fmt, signed=False)
            adam.apply(flat_p, flat_g, m, v, wd)
            out = (moment_save(m, fmt, signed=True, key=rounding_key(state.count, 2 * c))
                   + moment_save(v, fmt, signed=False, key=rounding_key(state.count, 2 * c + 1)))
            ev = st.store(out, mu_h + nu_h)
            del devs, m, v, out, flat_g
            if last:
                grads[i] = None
            st.wait(prev)
            prev = ev
        st.drain()
        state.count += 1
        state.step += 1
        return state


def _finite(*xs: float) -> bool:
    return all(np.isfinite(x) for x in xs)


class OffloadTrainer:
    """Two-phase trainer around OffloadAdamW for models whose f32
    moments do not fit on the card: one forward and backward (`loss_fn`,
    remat by default), then the streamed update.  Parameters and gradients
    stay on the device."""

    def __init__(self, cfg: UniMoEAudioConfig, params: Dict, opt: OffloadAdamW, *,
                 dispatch_mode: str = "dense", capacity: Optional[int] = None,
                 remat: bool = True, device="cuda"):
        self.device = resolve_device(device)
        for name, t in named_leaves(params):
            if t.device.type != self.device.type:
                raise ValueError(f"parameter {name} is on {t.device}, the trainer on {self.device}")
            if t.is_floating_point():
                t.requires_grad_(True)
        self.cfg = cfg
        self.opt = opt
        self.dispatch_mode, self.capacity, self.remat = dispatch_mode, capacity, remat
        self.state = opt.init_state(params)

    @property
    def pinned_bytes(self) -> int:
        return self.state.arena.nbytes if self.state.arena is not None else 0

    def close(self) -> None:
        """Release the host moments."""
        self.state.close()

    def train_step(self, batch: Dict, seed: int,
                   aux_weight: Optional[float] = None) -> Dict[str, float]:
        """One step on `batch` with the jitter seed fold_seed(seed, step) (as
        `train_step` draws it).  Returns host metrics."""
        st = self.state
        aux_w = aux_weight_at_step(self.cfg, st.step) if aux_weight is None else float(aux_weight)
        batch = place_batch(batch, self.device)
        leaves = [t for _, t in named_leaves(st.params)]
        loss, metrics = loss_fn(st.params, self.cfg, batch, fold_seed(seed, st.step), aux_w,
                                dispatch_mode=self.dispatch_mode, capacity=self.capacity,
                                remat=self.remat)
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
        del loss
        host = {k: float(v.detach()) for k, v in metrics.items()}
        host["grad_norm"] = float(global_norm(grads))
        if not _finite(host["loss"], host["grad_norm"]):
            host["skipped"] = 1.0                  # the reference's nan/inf filter
            return host
        self.opt.apply(st, grads, host["grad_norm"])
        host["skipped"] = 0.0
        return host
