"""Layer-streamed training: the decoder layers' weights and their Adam
moments live in host memory — counterpart of `unimoe_audio_tpu/train/stream.py`.

The reference's deepest offload regime is DeepSpeed ZeRO-2 with both
`offload_optimizer` and `offload_param` on the CPU
(deepspeed_zero2.conf:23-37).  `train/offload.py` covers the optimizer
half; here the layers' weights are host-resident too, and each step
streams one layer at a time through the card:

  forward:  layer weights in (the next layer's copy issued before this
            layer's compute), the layer (`models.model.layer_apply`), the
            [B, T, D] boundary activation kept on the card;
  backward: layer weights in again, the layer recomputed with grad on,
            `torch.autograd.grad` for (layer grads, d input), the grads out
            to host buffers;
  update:   per layer, (weights, grads, mu, nu) in, AdamW in f32 on the
            card, (weights, mu, nu) out into the same host buffers.

Device memory holds the outer weights (embeddings, final norm, heads) with
their gradients, the L boundary activations and about two layers in
flight, whatever the depth.  Host memory (`offload.HostArena`, page-locked
once) holds the weights, the moments (f32, or blockwise int8 —
`train/qmoment.py`) and, allocated at their first use, the gradients in
the parameter dtype or the f32 gradient sums of accumulation; every buffer
is reused step after step.  The host waits one layer behind the card
(`Streamer.wait`), as the JAX package blocks one step behind
(`stream.py:717-749`), so the caching allocator never queues every layer's
weights.  Each phase ends with `Streamer.drain()`: a host buffer written by
a device-to-host copy is read only after that copy's event.

The outer weights stay on the card, their moments in host memory through
`OffloadAdamW` (f32).  `lm_head` is frozen unless `train_lm_head`.  The
AdamW math is `OffloadAdamW`'s; a non-finite loss or gradient norm skips the
update.  Jitter seeds follow `text_model_forward`: layer l of the step at
count c draws from fold_seed(fold_seed(seed, c), l), micro-batch i of an
accumulated step from fold_seed(fold_seed(fold_seed(seed, c), i), l).

Checkpoints keep the JAX package's layout (`meta.json`, `layer_%03d.pkl`
with `p{i}` / `mu{i}` / `nu{i}` in its leaf order — dict keys sorted —,
`outer.pkl`), so a checkpoint written by its StreamTrainer resumes here.
bf16 leaves are written as {"__bf16__": uint16 bits} (numpy has no bf16);
the JAX package's ml_dtypes bf16 arrays are read through their bits.

Scope, as in the JAX package: text and codec training.  Vision-tower and
PEFT training run through `Trainer`; sliding-window layers are refused.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..api import resolve_device
from ..config import UniMoEAudioConfig
from ..core.bridge import to_torch
from ..core.export import _decode, _encode
from ..models.layers import compute_mrope, rms_norm
from ..models.model import (_shifted_ce, calculate_input_embedding, codec_logits_from_hidden,
                            fold_seed, init_layer_params, init_outer_params, layer_apply)
from ..ops.quant import matmul
from .offload import (MOMENT_DTYPES, HostArena, OffloadAdamW, Streamer, moment_load,
                      moment_save, moment_specs)
from .qmoment import dequantize_blockwise, padded_len, quantize_blockwise, rounding_key
from .step import _decays, aux_weight_at_step, named_leaves, place_batch

__all__ = ["StreamTrainer", "init_layer_params", "layer_apply"]

Path = Tuple[str, ...]


def sorted_leaves(tree, path: Path = ()) -> List[Tuple[Path, torch.Tensor]]:
    """(path, leaf) of a nested dict in the JAX package's leaf order (keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k], path + (k,))]
    return [(path, tree)]


def build_tree(paths: Sequence[Path], leaves: Sequence) -> Dict:
    out: Dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _copy(tree, device):
    """A nested dict / list of tensors, copied to device."""
    if isinstance(tree, dict):
        return {k: _copy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy(v, device) for v in tree]
    return tree.detach().to(device, copy=True)


def _load(x, device="cpu"):
    """A saved tree (numpy leaves, ml_dtypes bf16 arrays or the {"__bf16__"}
    tags of `core/export.py`) → tensors on device."""
    return to_torch(_decode(x), device, None)


def _sq(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ g² over the tensors, in f32."""
    return sum(torch.sum(torch.square(g.float())) for g in grads)


class StreamTrainer:
    """Depth-independent device memory: host-resident layer weights and
    moments, streamed one layer at a time through the card.

    Built from a full param tree (`params`, the port's layout, on any
    device), by random init (`params=None`, `seed`: each layer made on the
    card and copied straight into host memory — the same weights as
    `init_model_params(cfg, seed=seed)` on that device), or from a
    checkpoint (`restore_dir`)."""

    def __init__(self, cfg: UniMoEAudioConfig, params: Optional[Dict] = None, *,
                 seed: Optional[int] = None,
                 learning_rate: Union[Callable[[int], float], float] = 1e-4,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip: float = 1.0,
                 dispatch_mode: str = "dense", capacity: Optional[int] = None,
                 use_flash: Optional[bool] = None, train_lm_head: bool = False,
                 param_dtype=torch.bfloat16, restore_dir: Optional[str] = None,
                 moment_dtype: str = "float32", device="cuda"):
        tc = cfg.text_config
        if tc.has_sliding_layers:
            raise ValueError("StreamTrainer does not support sliding-window layers")
        if moment_dtype not in MOMENT_DTYPES:
            raise ValueError(f"moment_dtype must be float32|int8, got {moment_dtype}")
        self.device = resolve_device(device)
        self.cfg, self.tc, self.L = cfg, tc, tc.num_hidden_layers
        self.lr = learning_rate if callable(learning_rate) else (lambda c: learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.dispatch_mode, self.capacity, self.use_flash = dispatch_mode, capacity, use_flash
        self.train_lm_head = train_lm_head
        self.moment_format = moment_dtype
        self.streamer = Streamer(self.device)
        self._count = 0                                  # applied (non-skipped) steps
        self._grads: Optional[HostArena] = None          # per-layer grads, param dtype
        self._sums: Optional[HostArena] = None           # per-layer f32 grad sums

        # One layer's leaves in the JAX package's order, from a template made
        # on the meta device (no memory).
        if params is not None:
            template = params["layers"][0]
        else:
            template = init_layer_params(torch.Generator(), tc, dtype=param_dtype, device="meta")
        flat = sorted_leaves(template)
        self._paths = [p for p, _ in flat]
        # The template's own (insertion) order, for the dicts handed out.
        index = {p: i for i, p in enumerate(self._paths)}
        self._order = [index[tuple(n.split("/"))] for n, _ in named_leaves(template)]
        self._decay = [_decays("/".join(p)) for p in self._paths]
        self._sizes = [max(int(t.numel()), 1) for _, t in flat]
        shapes = [(tuple(t.shape), t.dtype) for _, t in flat]
        mom = [s for n in self._sizes for s in moment_specs(n, moment_dtype)]
        self._n_mom = len(mom) // len(self._sizes)       # host buffers per moment vector
        self._store = HostArena((shapes + mom + mom) * self.L, self.device)
        per = len(shapes) + 2 * len(mom)
        it = iter(self._store.tensors)
        self.layers_host, self.mu, self.nu = [], [], []
        for _ in range(self.L):
            chunk = [next(it) for _ in range(per)]
            self.layers_host.append(chunk[:len(shapes)])
            self.mu.append(chunk[len(shapes):len(shapes) + len(mom)])
            self.nu.append(chunk[len(shapes) + len(mom):])

        restored = None
        if restore_dir is not None:
            restored = self._load_from_dir(restore_dir)
            outer = restored["outer"]
        elif params is not None:
            for l, lp in enumerate(params["layers"]):
                for h, (_, t) in zip(self.layers_host[l], sorted_leaves(lp)):
                    h.copy_(t.detach())
            # Copies: the caller may hand the same tree to another trainer.
            outer = _copy({k: v for k, v in params.items() if k != "layers"}, self.device)
        else:
            if seed is None:
                raise ValueError("params=None requires a seed for random init")
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            for l in range(self.L):
                lp = init_layer_params(gen, tc, dtype=param_dtype, device=self.device)
                self.streamer.store([t for _, t in sorted_leaves(lp)], self.layers_host[l])
                self.streamer.drain()
                del lp
            outer = init_outer_params(gen, cfg, dtype=param_dtype, device=self.device)
        if restored is None:
            self.static_outer: Dict = {}
            if not train_lm_head and "lm_head" in outer:
                # Without text labels lm_head gets no gradient: frozen, no
                # moments, no decay (5 GB of moment traffic a step saved).
                self.static_outer["lm_head"] = outer.pop("lm_head")
            if "vision" in outer:
                self.static_outer["vision"] = outer.pop("vision")
        self.outer_opt = OffloadAdamW(learning_rate=self.lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay, grad_clip=grad_clip)
        # Sorted keys: the JAX package's leaf order of the outer moments.
        self.outer_state = self.outer_opt.init_state({k: outer[k] for k in sorted(outer)})
        if restored is not None:
            self.outer_state.count = self.outer_state.step = restored["count"]
            if restored["omu"] is not None:
                for mine, saved in ((self.outer_state.mu, restored["omu"]),
                                    (self.outer_state.nu, restored["onu"])):
                    hosts = [t for chunks in mine for parts in chunks for t in parts]
                    if len(hosts) != len(saved):
                        raise ValueError(f"outer moments: checkpoint holds {len(saved)} chunks, "
                                         f"the trainer {len(hosts)}")
                    for h, x in zip(hosts, saved):
                        h.copy_(_load(x).reshape(h.shape))

    # -- host memory -----------------------------------------------------
    @property
    def pinned_bytes(self) -> int:
        arenas = (self._store, self._grads, self._sums, self.outer_state.arena)
        return sum(a.nbytes for a in arenas if a is not None)

    def close(self) -> None:
        """Release the host buffers (the trainer is unusable afterwards)."""
        self.streamer.drain()
        self.layers_host = self.mu = self.nu = []
        for a in (self._store, self._grads, self._sums):
            if a is not None:
                a.close()
        self._store = self._grads = self._sums = None
        self.outer_state.close()

    def _grad_buffers(self, f32: bool) -> List[List[torch.Tensor]]:
        """Per-layer host gradient buffers, allocated at their first use."""
        if f32 and self._sums is None:
            self._sums = HostArena([((n,), torch.float32) for n in self._sizes] * self.L,
                                   self.device)
        if not f32 and self._grads is None:
            dtypes = [t.dtype for t in self.layers_host[0]]
            self._grads = HostArena([((n,), d) for n, d in zip(self._sizes, dtypes)] * self.L,
                                    self.device)
        ts = (self._sums if f32 else self._grads).tensors
        k = len(self._sizes)
        return [ts[l * k:(l + 1) * k] for l in range(self.L)]

    def _layer(self, leaves: Sequence[torch.Tensor]) -> Dict:
        return build_tree([self._paths[j] for j in self._order], [leaves[j] for j in self._order])

    # -- checkpoints (`stream.py:257-335`) -------------------------------
    def save(self, ckpt_dir: str, *, include_optimizer: bool = True) -> None:
        """Write the checkpoint layer by layer: host memory holds one
        layer's arrays at a time beside the trainer's buffers."""
        self.streamer.drain()
        os.makedirs(ckpt_dir, exist_ok=True)
        for l in range(self.L):
            arrs = {f"p{i}": _encode(t) for i, t in enumerate(self.layers_host[l])}
            if include_optimizer:
                arrs.update({f"mu{i}": _encode(t) for i, t in enumerate(self.mu[l])})
                arrs.update({f"nu{i}": _encode(t) for i, t in enumerate(self.nu[l])})
            with open(os.path.join(ckpt_dir, f"layer_{l:03d}.pkl"), "wb") as f:
                pickle.dump(arrs, f, protocol=4)
        st = self.outer_state
        blob = {"params": _encode(st.params), "static": _encode(self.static_outer),
                "count": int(self._count)}
        if include_optimizer:
            blob["mu"] = [_encode(t) for chunks in st.mu for parts in chunks for t in parts]
            blob["nu"] = [_encode(t) for chunks in st.nu for parts in chunks for t in parts]
        with open(os.path.join(ckpt_dir, "outer.pkl"), "wb") as f:
            pickle.dump(blob, f, protocol=4)
        with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
            json.dump({"format": 1, "layers": self.L, "count": int(self._count),
                       "optimizer": include_optimizer, "moment_dtype": self.moment_format,
                       "train_lm_head": "lm_head" in st.params}, f)

    def _load_from_dir(self, d: str) -> Dict:
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        if meta["layers"] != self.L:
            raise ValueError(f"checkpoint has {meta['layers']} layers, config wants {self.L}")
        if meta["train_lm_head"] != self.train_lm_head:
            raise ValueError(f"checkpoint was saved with train_lm_head={meta['train_lm_head']}; "
                             "construct with the same setting")
        ck_mom = meta.get("moment_dtype", "float32")
        n = len(self._sizes)
        for l in range(self.L):
            with open(os.path.join(d, f"layer_{l:03d}.pkl"), "rb") as f:
                arrs = pickle.load(f)
            for i, h in enumerate(self.layers_host[l]):
                h.copy_(_load(arrs[f"p{i}"]).reshape(h.shape))
            if meta["optimizer"]:
                for prefix, hosts, signed in (("mu", self.mu[l], True),
                                              ("nu", self.nu[l], False)):
                    saved = [_load(arrs[f"{prefix}{i}"])
                             for i in range(n * len(moment_specs(1, ck_mom)))]
                    for h, x in zip(hosts, self._convert_moments(saved, ck_mom, signed)):
                        h.copy_(x.reshape(h.shape))
            del arrs
        with open(os.path.join(d, "outer.pkl"), "rb") as f:
            blob = pickle.load(f)
        self.static_outer = _load(blob["static"], self.device)
        self._count = int(blob["count"])
        return {"outer": _load(blob["params"], self.device),
                "omu": blob.get("mu"), "onu": blob.get("nu"), "count": int(blob["count"])}

    def _convert_moments(self, saved: List[torch.Tensor], ck_mom: str,
                         signed: bool) -> List[torch.Tensor]:
        """One layer's saved moment leaves in this trainer's format (f32 ↔
        int8, rounding to nearest: a one-time requantization)."""
        if ck_mom == self.moment_format:
            return saved
        out = []
        for i, n in enumerate(self._sizes):
            if ck_mom == "float32":
                x = torch.nn.functional.pad(saved[i].float(), (0, padded_len(n) - n))
                out.extend(quantize_blockwise(x, signed=signed))
            else:
                out.append(dequantize_blockwise(saved[2 * i], saved[2 * i + 1],
                                                signed=signed)[:n])
        return out

    @property
    def step(self) -> int:
        return self._count

    # -- the step's pieces -------------------------------------------------
    def _parse_batch(self, batch: Dict):
        b = place_batch(batch, self.device)
        input_ids = b["input_ids"]
        mask = b.get("attention_mask")
        if mask is None:
            mask = torch.ones(input_ids.shape, dtype=torch.int32, device=self.device)
        labels, codec_labels = b.get("labels"), b.get("codec_labels")
        if labels is None and codec_labels is None:
            raise ValueError("batch needs labels and/or codec_labels")
        if labels is not None and "lm_head" not in self.outer_state.params:
            raise ValueError("text labels require train_lm_head=True at construction")
        return (input_ids, b.get("codec_input_ids"), mask, labels, codec_labels,
                b.get("aux_balance_weight"), b.get("position_ids"))

    def _embed(self, ep, input_ids, codec_ids, mask, position_ids, abw):
        emb = calculate_input_embedding(ep, input_ids, codec_ids, self.cfg.codec_placeholder_value)
        if position_ids is None:
            pos = torch.cumsum(mask, dim=-1) - 1
            pos = torch.where(mask == 0, torch.ones_like(pos), pos)
            position_ids = pos[None].expand(3, *input_ids.shape)
        tc = self.tc
        cos, sin = compute_mrope(position_ids, tc.head_dim, tc.rope_theta, tc.mrope_section)
        return emb, cos, sin, (mask * abw if abw is not None else None)

    def _layer_fwd(self, lp, h, cos, sin, mask, abw, seed, training=True):
        return layer_apply(lp, h, cos, sin, self.tc, kv_valid_mask=mask, padding_token_mask=mask,
                           aux_balance_weight=abw, training=training, seed=seed,
                           use_flash=self.use_flash, dispatch_mode=self.dispatch_mode,
                           capacity=self.capacity)

    def _head_loss(self, hp, h, codec_labels, labels, aux_sum, aux_w):
        """(loss, codec_loss, mean aux) from the last hidden state: the
        final norm, the text CE with labels, the per-channel codec CE summed
        over channels, plus aux_w x the mean aux loss (`stream.py:524-566`)."""
        hn = rms_norm(h, hp["norm"], self.tc.rms_norm_eps)
        mean_aux = aux_sum / self.L
        loss = aux_w * mean_aux
        codec_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        if labels is not None:
            loss = loss + _shifted_ce(matmul(hn, hp["lm_head"]).float(), labels, (0, 1))
        if codec_labels is not None:
            codec_loss = _shifted_ce(codec_logits_from_hidden(hp, hn, self.cfg),
                                     codec_labels, (0, 1)).sum()
            loss = loss + codec_loss
        return loss, codec_loss, mean_aux

    @torch.no_grad()
    def _stream_fwd(self, ep, input_ids, codec_ids, mask, position_ids, abw, seeds=None):
        """Forward: layers streamed in (`stream.py:717-749`).  With `seeds`
        (training) the boundary activations are kept for the backward;
        without, the layers run in eval mode (no jitter) and keep none."""
        training = seeds is not None
        st = self.streamer
        emb, cos, sin, full_abw = self._embed(ep, input_ids, codec_ids, mask, position_ids, abw)
        boundaries: List[torch.Tensor] = []
        aux_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        topk_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        h = emb
        nxt = st.fetch(self.layers_host[0])
        prev = None
        for l in range(self.L):
            cur = st.ready(nxt)
            if l + 1 < self.L:
                nxt = st.fetch(self.layers_host[l + 1])
            if training:
                boundaries.append(h)
            out = self._layer_fwd(self._layer(cur), h, cos, sin, mask, full_abw,
                                  seeds[l] if training else None, training=training)
            h = out.hidden
            aux_sum = aux_sum + out.aux_loss.float()
            topk_sum = topk_sum + out.router_top_k.float().mean()
            del cur, out
            ev = st.mark()
            st.wait(prev)                              # layer l-1 done
            prev = ev
        return h, cos, sin, full_abw, boundaries, aux_sum, topk_sum

    def _stream_bwd(self, boundaries, g_h, cos, sin, mask, full_abw, seeds, aux_cot,
                    mode: str):
        """Backward: layers streamed in in reverse, recomputed with grad on,
        grads out to host (`stream.py:751-798`).  mode 'single' writes grads
        in the param dtype; 'first' opens the f32 sums; 'acc' streams each
        layer's previous sum in with its weights and writes the new sum.
        Returns (the gradient at the embedding output, Σ g² of what was
        written — in 'acc' mode the running sums', so the last micro-batch's
        is the accumulated total's)."""
        st, L = self.streamer, self.L
        hosts = self._grad_buffers(mode != "single")
        acc = mode == "acc"
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        n = len(self._paths)

        def fetch(l):
            return st.fetch(self.layers_host[l] + (hosts[l] if acc else []))

        nxt = fetch(L - 1)
        prev = None
        for l in range(L - 1, -1, -1):
            cur = st.ready(nxt)
            if l > 0:
                nxt = fetch(l - 1)
            leaves = [t.requires_grad_(t.is_floating_point()) for t in cur[:n]]
            h_in = boundaries[l].requires_grad_(True)
            boundaries[l] = None
            with torch.enable_grad():
                out = self._layer_fwd(self._layer(leaves), h_in, cos, sin, mask, full_abw,
                                      seeds[l])
                outs, cots = [out.hidden], [g_h]
                if out.aux_loss.requires_grad:
                    outs.append(out.aux_loss)
                    cots.append(torch.full_like(out.aux_loss, aux_cot))
                diff = [t for t in leaves if t.requires_grad]
                got = iter(torch.autograd.grad(outs, diff + [h_in], cots, allow_unused=True))
            grads = [next(got) if t.requires_grad else None for t in leaves]
            g_h = next(got)
            grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
            del out, outs, cots, diff, h_in
            if mode == "single":
                written = [g.reshape(-1) for g in grads]
            else:
                written = [g.reshape(-1).float() for g in grads]
                if acc:
                    written = [w.add_(p) for w, p in zip(written, cur[n:])]
            sq = sq + _sq(written)
            ev = st.store(written, hosts[l])
            del cur, leaves, grads, written
            st.wait(prev)                              # layer l+1 done
            prev = ev
        st.drain()
        return g_h, sq

    def _head_grads(self, hp, h, codec_labels, labels, aux_sum, aux_w):
        keys = list(hp)
        leaves = [hp[k].detach().requires_grad_(True) for k in keys]
        h = h.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, codec_loss, mean_aux = self._head_loss(dict(zip(keys, leaves)), h, codec_labels,
                                                         labels, aux_sum, aux_w)
            *g_hp, g_h = torch.autograd.grad(loss, leaves + [h], allow_unused=True)
        g_hp = [torch.zeros_like(t) if g is None else g for g, t in zip(g_hp, leaves)]
        return loss.detach(), codec_loss.detach(), mean_aux, dict(zip(keys, g_hp)), g_h

    def _embed_grads(self, ep, input_ids, codec_ids, g_emb):
        keys = list(ep)
        leaves = [ep[k].detach().requires_grad_(True) for k in keys]
        with torch.enable_grad():
            emb = calculate_input_embedding(dict(zip(keys, leaves)), input_ids, codec_ids,
                                            self.cfg.codec_placeholder_value)
            g_ep = torch.autograd.grad(emb, leaves, g_emb, allow_unused=True)
        return {k: torch.zeros_like(t) if g is None else g for k, g, t in zip(keys, g_ep, leaves)}

    @torch.no_grad()
    def _update_layers(self, grads_host, adam) -> None:
        """The per-layer AdamW (`stream.py:595-669`): weights, grads and
        moments in, weights and moments out."""
        st, fmt, n, k = self.streamer, self.moment_format, len(self._paths), self._n_mom

        def fetch(l):
            return st.fetch(self.layers_host[l] + grads_host[l] + self.mu[l] + self.nu[l])

        nxt = fetch(0)
        prev = None
        for l in range(self.L):
            devs = st.ready(nxt)
            if l + 1 < self.L:
                nxt = fetch(l + 1)
            ps, gs = devs[:n], devs[n:2 * n]
            mus, nus = devs[2 * n:2 * n + k * n], devs[2 * n + k * n:]
            out_mu, out_nu = [], []
            for i in range(n):
                size = self._sizes[i]
                m = moment_load(mus[k * i:k * (i + 1)], size, fmt, signed=True)
                v = moment_load(nus[k * i:k * (i + 1)], size, fmt, signed=False)
                adam.apply(ps[i].view(-1), gs[i], m, v,
                           self.weight_decay if self._decay[i] else 0.0)
                leaf = (l * n + i) * 2
                out_mu += moment_save(m, fmt, signed=True, key=rounding_key(self._count, leaf))
                out_nu += moment_save(v, fmt, signed=False,
                                      key=rounding_key(self._count, leaf + 1))
            ev = st.store(ps + out_mu + out_nu, self.layers_host[l] + self.mu[l] + self.nu[l])
            del devs, ps, gs, mus, nus, out_mu, out_nu
            st.wait(prev)
            prev = ev
        st.drain()

    def _split_outer(self, labels_present: bool):
        outer = self.outer_state.params
        ep = {"embed_tokens": outer["embed_tokens"], "codec_embed": outer["codec_embed"]}
        hp = {"norm": outer["norm"], "codec_head": outer["codec_head"]}
        if labels_present:
            hp["lm_head"] = outer["lm_head"]
        return outer, ep, hp

    def _outer_grads(self, outer, g_ep, g_hp) -> List[torch.Tensor]:
        """Outer grads aligned with the outer optimizer's leaves; lm_head,
        trainable but without text labels in the batch, gets zeros (its
        moments still decay)."""
        g = {**g_ep, **g_hp}
        return [g[k] if k in g else torch.zeros_like(outer[k]) for k in outer]

    # -- training ----------------------------------------------------------
    def train_step(self, batch: Union[Dict, Sequence[Dict]], seed: int,
                   aux_weight: Optional[float] = None) -> Dict[str, float]:
        """One streamed step; returns host metrics.  A list of micro-batch
        dicts accumulates f32 gradient sums in host memory and applies the
        clipped mean gradient once (`stream.py:800-1014`)."""
        if isinstance(batch, (list, tuple)):
            if len(batch) > 1:
                return self._train_step_accum(list(batch), seed, aux_weight)
            batch = batch[0]
        L = self.L
        aux_w = aux_weight_at_step(self.cfg, self._count) if aux_weight is None \
            else float(aux_weight)
        step_seed = fold_seed(seed, self._count)
        seeds = [fold_seed(step_seed, l) for l in range(L)]
        input_ids, codec_ids, mask, labels, codec_labels, abw, position_ids = \
            self._parse_batch(batch)
        outer, ep, hp = self._split_outer(labels is not None)

        h, cos, sin, full_abw, boundaries, aux_sum, topk_sum = self._stream_fwd(
            ep, input_ids, codec_ids, mask, position_ids, abw, seeds)
        loss, codec_loss, mean_aux, g_hp, g_h = self._head_grads(
            hp, h, codec_labels, labels, aux_sum, aux_w)
        del h
        g_h, sq_layers = self._stream_bwd(boundaries, g_h, cos, sin, mask, full_abw, seeds,
                                          aux_w / L, "single")
        g_ep = self._embed_grads(ep, input_ids, codec_ids, g_h)
        del g_h
        gnorm = torch.sqrt(_sq(list(g_hp.values())) + sq_layers + _sq(list(g_ep.values())))
        vals = torch.stack([loss, codec_loss, mean_aux.float(), topk_sum, gnorm]).tolist()
        metrics = {"loss": vals[0], "codec_loss": vals[1], "aux_loss": vals[2],
                   "mean_top_k": vals[3] / L, "grad_norm": vals[4]}
        if not (np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])):
            metrics["skipped"] = 1.0                   # the reference's nan/inf filter
            return metrics
        self._update_layers(self._grad_buffers(False),
                            self.outer_opt.step_scalars(self._count, metrics["grad_norm"]))
        self.outer_opt.apply(self.outer_state, self._outer_grads(outer, g_ep, g_hp),
                             metrics["grad_norm"])
        self._count += 1
        metrics["skipped"] = 0.0
        return metrics

    def _train_step_accum(self, batches: List[Dict], seed: int,
                          aux_weight: Optional[float]) -> Dict[str, float]:
        """Micro-batch i streams its forward and backward; micro-batch i > 0
        streams each layer's running f32 sum in with its weights.  The
        update applies the clipped mean: the layers' sums times
        clip_scale / n, the outer sums divided by n and cast to the param
        dtype (`stream.py:904-1014`)."""
        L, n = self.L, len(batches)
        aux_w = aux_weight_at_step(self.cfg, self._count) if aux_weight is None \
            else float(aux_weight)
        step_seed = fold_seed(seed, self._count)
        acc_outer = None
        vals = []
        sq_layers = None
        has_labels = None
        outer = None
        for i, b in enumerate(batches):
            input_ids, codec_ids, mask, labels, codec_labels, abw, position_ids = \
                self._parse_batch(b)
            if has_labels is None:
                has_labels = labels is not None
            elif (labels is not None) != has_labels:
                raise ValueError("micro-batches must agree on label kinds (text labels present "
                                 "in some but not all)")
            outer, ep, hp = self._split_outer(labels is not None)
            micro = fold_seed(step_seed, i)
            seeds = [fold_seed(micro, l) for l in range(L)]
            h, cos, sin, full_abw, boundaries, aux_sum, topk_sum = self._stream_fwd(
                ep, input_ids, codec_ids, mask, position_ids, abw, seeds)
            loss, codec_loss, mean_aux, g_hp, g_h = self._head_grads(
                hp, h, codec_labels, labels, aux_sum, aux_w)
            del h
            g_h, sq_layers = self._stream_bwd(boundaries, g_h, cos, sin, mask, full_abw, seeds,
                                              aux_w / L, "first" if i == 0 else "acc")
            g_ep = self._embed_grads(ep, input_ids, codec_ids, g_h)
            del g_h
            g = {**g_ep, **g_hp}
            if acc_outer is None:
                acc_outer = {k: v.float() for k, v in g.items()}
            else:
                for k, v in g.items():
                    acc_outer[k] = acc_outer[k] + v.float()
            vals.append(torch.stack([loss, codec_loss, mean_aux.float(), topk_sum]))
            del g, g_ep, g_hp
        gnorm_sum = torch.sqrt(sq_layers + _sq(list(acc_outer.values())))
        ms = torch.stack(vals).cpu().numpy()
        gnorm_v = float(gnorm_sum) / n
        metrics = {"loss": float(np.mean(ms[:, 0])), "codec_loss": float(np.mean(ms[:, 1])),
                   "aux_loss": float(np.mean(ms[:, 2])), "mean_top_k": float(np.mean(ms[:, 3])) / L,
                   "grad_norm": gnorm_v, "micro_batches": float(n)}
        if not (np.isfinite(metrics["loss"]) and np.isfinite(gnorm_v)):
            metrics["skipped"] = 1.0
            return metrics
        self._update_layers(self._grad_buffers(True),
                            self.outer_opt.step_scalars(self._count, gnorm_v, divide=n))
        mean = {k: (a / n).to(outer[k].dtype) for k, a in acc_outer.items()}
        del acc_outer
        self.outer_opt.apply(self.outer_state, self._outer_grads(outer, mean, {}), gnorm_v)
        self._count += 1
        metrics["skipped"] = 0.0
        return metrics

    @torch.no_grad()
    def evaluate(self, batches, max_batches: Optional[int] = None) -> Dict[str, float]:
        """Forward-only pass (no jitter, no boundaries kept, parameters
        untouched): the mean eval_ metrics over `batches`
        (`stream.py:1016-1082`)."""
        sums: Dict[str, float] = {}
        count = 0
        aux_w = aux_weight_at_step(self.cfg, self._count)
        for j, batch in enumerate(batches):
            if max_batches is not None and j >= max_batches:
                break
            input_ids, codec_ids, mask, labels, codec_labels, abw, position_ids = \
                self._parse_batch(batch)
            _, ep, hp = self._split_outer(labels is not None)
            h, *_, aux_sum, _ = self._stream_fwd(ep, input_ids, codec_ids, mask, position_ids,
                                                 abw)
            loss, codec_loss, mean_aux = self._head_loss(hp, h, codec_labels, labels, aux_sum,
                                                         aux_w)
            for k, v in zip(("loss", "codec_loss", "aux_loss"),
                            torch.stack([loss, codec_loss, mean_aux.float()]).tolist()):
                sums[k] = sums.get(k, 0.0) + v
            count += 1
        return {f"eval_{k}": v / max(count, 1) for k, v in sums.items()}

    def full_params(self, device="cpu") -> Dict:
        """The whole model in the port's layout and key order, copied to
        `device` (on the CPU it needs the model in host memory twice)."""
        self.streamer.drain()
        src = _copy({**self.outer_state.params, **self.static_outer}, device)
        out = {"embed_tokens": src.pop("embed_tokens"),
               "layers": [self._layer(_copy(lp, device)) for lp in self.layers_host]}
        for k in ("norm", "lm_head", "codec_embed", "codec_head"):
            out[k] = src.pop(k)
        return {**out, **src}
