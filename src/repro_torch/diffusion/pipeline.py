"""CachedDenoiser and the serving engine's slot functions — the port of the
JAX `diffusion/pipeline.py`, with classifier-free guidance (an optional
cache policy on the unconditional branch, FasterCacheCFG), negative-prompt
vectors in place of the null-class embedding, and text prompts for the
text-enabled configs (dit-t2i, dit-t2v): the cond rows cross-attend over
the prompt's K/V and the uncond rows over the negative prompt's, both
projected once (at construction, or per admission wave in the engine).

Modalities: every entry point dispatches on the config — the plain
isotropic DiT (image latents, audio mel-spectrograms) when
`cfg.dit_num_frames == 0`, the factorized spatio-temporal video DiT
(repro_torch.models.video_dit) otherwise.  Latents are always
(B, cfg.dit_tokens, cfg.dit_in_dim), so the cache and serving stack is
modality-agnostic; only the backbone and TeaCache's signal change.

Granularities (survey Fig. 2 reuse-granularity axis):

  MODEL     — one policy gates the full backbone output; TeaCache's signal
              (the AdaLN-modulated first-block input, Eq. 22) is wired
              through for a policy that reads it.
  BLOCK     — one policy state per block, threaded through the layer loop
              (core.CachedStack).
  DEEPCACHE — the first `shallow_n` blocks always compute, the deep
              section is gated as one unit (Δ-DiT's front/rear reading of
              DeepCache's U-Net split).
  PAB_VIDEO — video backbone only: each block's spatial-attention,
              temporal-attention and MLP branch outputs cached and
              broadcast over per-module-type ranges
              (core.TemporalPABStack).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import (CachedStack, CachePolicy, FasterCacheCFG,
                              NoCachePolicy, TemporalPABStack, layer_params,
                              static_plan)
from repro_torch.device import (DeviceLike, resolve_device, to_device,
                                tree_device)
from repro_torch.models import dit, video_dit
from repro_torch.obs.watch import host_read

GRANULARITIES = ("model", "block", "deepcache", "pab_video")


def backbone_module(cfg):
    """The backbone module for this config's modality (dit | video_dit)."""
    return video_dit if cfg.dit_num_frames > 0 else dit


def backbone_fns(params, cfg):
    """(forward_fn, signal_fn) bound to params for this config's modality.

    forward_fn(xs, ts, labels, y_embed=None, txt_kv=None, txt_mask=None)
    -> eps for xs (B, T, D), ts (B,) timesteps, labels (B,) class ids,
    y_embed (B, d) an optional conditioning-vector override (negative
    prompts), txt_kv / txt_mask the per-layer text K/V tables and key mask
    of a text-enabled config (models.dit.text_kv); signal_fn(xs, ts,
    labels) -> TeaCache's modulated first-block input (computed before the
    first block, so prompts never move a refresh decision)."""
    mod = backbone_module(cfg)

    def forward_fn(xs, ts, labels, y_embed=None, txt_kv=None, txt_mask=None):
        return mod.forward(params, xs, ts.float(), labels.long(), cfg,
                           y_embed=y_embed, txt_kv=txt_kv, txt_mask=txt_mask)

    def signal_fn(xs, ts, labels):
        h, c = mod.embed_patches(params, xs, ts.float(), labels.long(), cfg)
        return mod.modulated_signal(params, h, c, cfg)

    return forward_fn, signal_fn


def _null_embed_rows(params, nulls, null_vecs, null_mask):
    """Per-row unconditional conditioning: the null-class embedding,
    replaced by the request's negative-prompt vector where `null_mask` is
    set (the vector is cast to the embedding table's dtype, as in JAX)."""
    ce = params["class_embed"][nulls.long()]
    return torch.where(null_mask[:, None], null_vecs.to(ce.dtype), ce)


def _as_text(text, cfg, device):
    """Normalize prompt conditioning to (te (L, d) f32, tm (L,) bool) on
    `device`, te zeroed at masked positions (the cross-attention no-op's
    invariant).  `text` is a PromptEmbedding, an (embed, mask) pair, or
    None."""
    if text is None:
        return None
    if cfg.dit_text_len <= 0:
        raise ValueError(f"config '{cfg.name}' is not text-enabled "
                         f"(dit_text_len == 0) but a prompt was given")
    te, tm = (text.embed, text.mask) if hasattr(text, "embed") else text
    te = torch.tensor(np.asarray(te), dtype=torch.float32, device=device)
    tm = torch.tensor(np.asarray(tm), dtype=torch.bool, device=device)
    if te.ndim == 3:                      # batched (1, L, d) -> (L, d)
        te, tm = te[0], tm[0]
    if tuple(te.shape) != (cfg.dit_text_len, cfg.d_model):
        raise ValueError(f"prompt embedding shape {tuple(te.shape)} != "
                         f"({cfg.dit_text_len}, {cfg.d_model})")
    return torch.where(tm[:, None], te, 0.0), tm


def _text_pooled(text):
    """The pooled (d_model,) view of a normalized (te, tm) pair: the
    vector the CFG negative-prompt (null-vector) path conditions on."""
    te, tm = text
    return te.sum(dim=0) / tm.sum().clamp(min=1)


def _text_operands(params, cfg, text, device):
    """(tk, tv, tm) of one prompt, batch 1: its K/V over all layers
    (projected here, once) and its mask; zero tables and an all-False mask
    for None, the no-op of a text-enabled config."""
    if text is None:
        return dit.resolve_txt(params, cfg, 1, device=device)
    tk, tv = dit.text_kv(params, text[0][None], cfg)
    return tk, tv, text[1][None]


def _txt_kwargs(ops, B):
    """forward() kwargs broadcasting one prompt's (tk, tv, tm) to batch B
    ({} on a text-free config)."""
    if ops is None:
        return {}
    tk, tv, tm = ops
    return {"txt_kv": (tk.expand(B, *tk.shape[1:]),
                       tv.expand(B, *tv.shape[1:])),
            "txt_mask": tm.expand(B, -1)}


def _cfg_kwargs(cfg_policy, cfg_w, cond_out):
    """The signals FasterCacheCFG's slot step reads (no other policy takes
    them)."""
    if isinstance(cfg_policy, FasterCacheCFG):
        return {"cfg_w": cfg_w, "cond_out": cond_out}
    return {}


class CachedDenoiser:
    """eps_hat, state = denoiser(state, i, x, t); the cache policy gates the
    backbone at `granularity` (see the module docstring; `shallow_n` is
    deepcache's always-computed front).  At model granularity TeaCache's
    signal is computed only for a policy that reads it.  With
    cfg_scale > 0 the unconditional branch runs under `cfg_policy` (None:
    it recomputes every step), conditioned on the null class or on
    `null_embed`, a (d_model,) negative-prompt vector.

    `text` / `neg_text` (a PromptEmbedding or an (embed, mask) pair;
    text-enabled configs only) condition the cond / uncond branch through
    cross-attention.  Their K/V over all layers are projected once, here;
    the block and deepcache stacks read each layer's slice, and pab_video's
    cross branch projects from the embeddings on the steps it refreshes,
    as JAX's.  A `neg_text` defaults `null_embed` to its pooled
    embedding."""

    def __init__(self, params, cfg, policy: Optional[CachePolicy] = None,
                 granularity: str = "model", shallow_n: int = 4,
                 cfg_scale: float = 0.0,
                 cfg_policy: Optional[CachePolicy] = None,
                 class_label: int = 0, null_embed=None, text=None,
                 neg_text=None, device: DeviceLike = None):
        if granularity not in GRANULARITIES:
            raise ValueError(f"granularity must be one of {GRANULARITIES}, "
                             f"got {granularity!r}")
        self.device = resolve_device(device)
        if tree_device(params) != self.device:
            raise ValueError(f"params live on {tree_device(params)}, the "
                             f"denoiser runs on {self.device}")
        self.params, self.cfg = params, cfg
        self.policy = policy or NoCachePolicy()
        self.granularity = granularity
        self.shallow_n = shallow_n
        self.cfg_scale = float(cfg_scale)
        self.cfg_policy = cfg_policy
        self.class_label = class_label
        self._text = _as_text(text, cfg, self.device)
        neg = _as_text(neg_text, cfg, self.device)
        if null_embed is None and neg is not None:
            null_embed = _text_pooled(neg)
        self.null_embed = (None if null_embed is None else torch.as_tensor(
            null_embed, dtype=torch.float32, device=self.device))
        self._mod = backbone_module(cfg)
        self._forward, self._signal = backbone_fns(params, cfg)
        self._txt = self._neg = None
        self._blocks = params["blocks"]
        if cfg.dit_text_len > 0:
            self._txt = _text_operands(params, cfg, self._text, self.device)
            self._neg = _text_operands(params, cfg, neg, self.device)
            # each layer's prompt K/V ride beside its params (a leading
            # layer axis), so the block loops slice them with the weights
            tk, tv, _ = self._txt
            self._blocks = dict(params["blocks"], txt_k=tk.transpose(0, 1),
                                txt_v=tv.transpose(0, 1))
        if granularity == "block":
            self._stack = CachedStack(self._block, self.policy,
                                      cfg.num_layers)
        elif granularity == "pab_video":
            if cfg.dit_num_frames <= 0:
                raise ValueError("pab_video granularity needs the factorized "
                                 "video backbone (cfg.dit_num_frames > 0)")
            self._stack = TemporalPABStack(video_dit.pab_branch_fns(cfg),
                                           cfg.num_layers)

    def _block(self, p, x, c):
        """One block under the cond branch's text conditioning (`p` holds
        the layer's prompt K/V on a text-enabled config)."""
        txt = None
        if self._txt is not None:
            B = x.shape[0]
            txt = (p["txt_k"].expand(B, -1, -1), p["txt_v"].expand(B, -1, -1),
                   self._txt[2].expand(B, -1))
        if self._mod is video_dit:
            return video_dit.video_block(p, x, c, self.cfg, txt=txt)
        return dit.dit_block(p, x, c, self.cfg, txt=txt)

    def init_state(self, batch: int):
        cfgm = self.cfg
        feat = (batch, cfgm.dit_tokens, cfgm.d_model)
        eps_shape = (batch, cfgm.dit_tokens, cfgm.dit_in_dim)
        if self.granularity == "model":
            kw = {"signal_shape": feat} if self.policy.uses_signal else {}
            pol = self.policy.init_state(eps_shape, device=self.device, **kw)
        elif self.granularity in ("block", "pab_video"):
            pol = self._stack.init(feat, device=self.device)
        else:   # deepcache: one cache over the deep section's hidden output
            pol = self.policy.init_state(feat, device=self.device)
        state = {"policy": pol}
        if self.cfg_policy is not None:
            state["cfg"] = self.cfg_policy.init_state(eps_shape,
                                                      device=self.device)
        return state

    def _run(self, h, c, lo, hi):
        for i in range(lo, hi):
            h = self._block(layer_params(self._blocks, i), h, c)
        return h

    def _backbone(self, x_lat, t_vec, y, state, step):
        """One conditional forward under the configured granularity:
        (eps_hat, new policy state)."""
        params, cfgm, mod = self.params, self.cfg, self._mod
        if self.granularity == "model":
            sig = ({"signal": self._signal(x_lat, t_vec, y)}
                   if self.policy.uses_signal else {})
            return self.policy.apply(
                state, step, x_lat,
                lambda lat: self._forward(
                    lat, t_vec, y, **_txt_kwargs(self._txt, lat.shape[0])),
                **sig)
        h, c = mod.embed_patches(params, x_lat, t_vec.float(), y.long(), cfgm)
        if self.granularity == "pab_video" and self._txt is not None:
            # the text-enabled branch fns take (c, te, tm) stack args
            B = h.shape[0]
            te = (self._text[0] if self._text is not None
                  else torch.zeros((cfgm.dit_text_len, cfgm.d_model),
                                   device=self.device))
            h, new_state = self._stack(state, step, h, params["blocks"], c,
                                       te.expand(B, -1, -1),
                                       self._txt[2].expand(B, -1))
        elif self.granularity in ("block", "pab_video"):
            h, new_state = self._stack(state, step, h, self._blocks, c)
        else:   # deepcache split (a stack shallower than shallow_n has
            # no deep section, as JAX's slices give)
            F, L = min(self.shallow_n, cfgm.num_layers), cfgm.num_layers
            h = self._run(h, c, 0, F)
            h, new_state = self.policy.apply(
                state, step, h, lambda hh: self._run(hh, c, F, L))
        return mod.final_layer(params, h, c, cfgm), new_state

    def __call__(self, state, step: int, x_lat, t_vec):
        B = x_lat.shape[0]
        state = state if state is not None else self.init_state(B)
        y_cond = torch.full((B,), self.class_label, dtype=torch.long,
                            device=self.device)
        eps_c, pol_state = self._backbone(x_lat, t_vec, y_cond,
                                          state["policy"], step)
        new_state = {"policy": pol_state}
        if self.cfg_scale > 0.0:
            y_null = torch.full((B,), self.cfg.dit_num_classes,
                                dtype=torch.long, device=self.device)
            y_embed = (None if self.null_embed is None
                       else self.null_embed[None].expand(B, -1))

            def uncond(lat):
                # the uncond rows attend over the negative prompt's K/V
                # (zero tables when there is none)
                return self._forward(lat, t_vec, y_null, y_embed=y_embed,
                                     **_txt_kwargs(self._neg, lat.shape[0]))

            if self.cfg_policy is not None:
                eps_u, new_state["cfg"] = self.cfg_policy.apply(
                    state["cfg"], step, x_lat, uncond, cond_out=eps_c)
            else:
                eps_u = uncond(x_lat)
            eps_c = eps_u + self.cfg_scale * (eps_c - eps_u)
        return eps_c, new_state


def slot_denoise_fns(params, cfg, policy: CachePolicy):
    """Slot-parallel entry point (model granularity), the dense engine's
    cond branch:

      backbone_fn(xs, ts, labels, txt=None) -> eps
          the plain slot-batched forward: the slot axis is the batch axis.
          `txt` is the engine's per-slot text-table dict (None or {} on a
          text-free engine): "k", "v" (2S, nl, L, H*hd) and "mask" (2S, L),
          rows [0, S) the slots' prompts, rows [S, 2S) their negative
          prompts; the S cond rows read the first half.
      apply_fn(states, steps, xs, ys, want=None, signal=None)
          -> (eps, states)
          the policy's step over the whole slot axis on the plan's host
          `want` and signal (`CachePolicy.apply_slots`).
      want_fn(states, steps, xs, ts, labels) -> (SlotWant, signal)
          every slot's decision on the device; TeaCache's signal is
          computed over the slot batch only for a policy that reads it
          (else None).
    """
    forward_fn, signal_fn = backbone_fns(params, cfg)

    def backbone_fn(xs, ts, labels, txt=None):
        if not txt:
            return forward_fn(xs, ts, labels)
        S = xs.shape[0]
        return forward_fn(xs, ts, labels, txt_kv=(txt["k"][:S], txt["v"][:S]),
                          txt_mask=txt["mask"][:S])

    def want_fn(states, steps, xs, ts, labels):
        sig = signal_fn(xs, ts, labels) if policy.uses_signal else None
        return policy.want_slots(states, steps, xs, sig), sig

    return backbone_fn, policy.apply_slots, want_fn


def slot_cfg_denoise_fns(params, cfg, policy: CachePolicy,
                         cfg_policy: Optional[CachePolicy] = None):
    """CFG-aware slot-parallel entry point of the dense engine: each slot
    carries a cond state (`policy`) and an uncond state (`cfg_policy`; None
    means the uncond branch recomputes every step).

      backbone2_fn(xs, ts, labels, nulls, null_vecs, null_mask, txt=None)
          -> (y_c, y_u)
          one 2S-row pass over [cond rows; uncond rows]; uncond rows
          condition on the null label, or on the slot's negative-prompt
          vector where `null_mask` is set, and cross-attend over the
          negative prompts' half of `txt` (whose 2S rows line up with the
          pass's rows, so no table is copied).
      backbone_fn(xs, ts, labels, txt=None) -> y_c
          the S-row cond-only pass.
      apply_fn(states, steps, xs, scales, cfg_ws, y_c, y_u, want=None,
               want_u=None, signal=None) -> (eps, states)
          both branches' slot steps on the plan's host decisions: the
          cond policy on `want`, the uncond policy on `want_u` with each
          slot's progress weight `cfg_ws` and its cond output (what
          FasterCacheCFG reads).  A slot with scale <= 0 keeps its cond
          output, never blended.  Rows the tick did not compute arrive as
          zeros and only reach branches the selects discard.
    """
    uncond = cfg_policy if cfg_policy is not None else NoCachePolicy()
    forward_fn, _ = backbone_fns(params, cfg)
    backbone_fn, cond_apply, _ = slot_denoise_fns(params, cfg, policy)

    def backbone2_fn(xs, ts, labels, nulls, null_vecs, null_mask, txt=None):
        S = xs.shape[0]
        ce_c = params["class_embed"][labels.long()]
        ce_u = _null_embed_rows(params, nulls, null_vecs, null_mask)
        kw = ({"txt_kv": (txt["k"], txt["v"]), "txt_mask": txt["mask"]}
              if txt else {})
        eps = forward_fn(torch.cat([xs, xs]), torch.cat([ts, ts]),
                         torch.cat([labels, nulls]),
                         y_embed=torch.cat([ce_c, ce_u]), **kw)
        return eps[:S], eps[S:]

    def apply_fn(states, steps, xs, scales, cfg_ws, y_c, y_u, want=None,
                 want_u=None, signal=None):
        eps_c, pol_state = cond_apply(states["policy"], steps, xs, y_c,
                                      want=want, signal=signal)
        eps_u, cfg_state = uncond.apply_slots(
            states["cfg"], steps, xs, y_u, want=want_u,
            **_cfg_kwargs(uncond, cfg_ws, eps_c))
        sc = scales.view(-1, 1, 1)
        eps = torch.where(sc > 0.0, eps_u + sc * (eps_c - eps_u), eps_c)
        return eps, {"policy": pol_state, "cfg": cfg_state}

    return backbone2_fn, backbone_fn, apply_fn


def slot_compact_denoise_fns(params, cfg, policy: CachePolicy,
                             cfg_policy: Optional[CachePolicy] = None):
    """Row-compacted slot-parallel entry point for the serving engine.

      compact_backbone_fn(xs, tvals, labels, nulls, null_vecs, null_mask,
                          txt, row_slot, row_uncond, row_dest) -> (y_c, y_u)
          gathers the `bucket` wanted rows (row_slot picks the source slot,
          row_uncond the null conditioning: the null label, or the slot's
          negative-prompt vector where `null_mask` is set; with text, each
          row's K/V and mask are gathered from table row row_slot +
          S * row_uncond on the device: the slot's prompt for a cond row,
          its negative prompt for an uncond row), runs the
          backbone over that batch only, and scatters each row into a
          (2S+1)-row buffer at row_dest (cond row i -> i, uncond row i ->
          S + i, padding -> the dump row 2S), split back into S-row y_c /
          y_u.  Rows not gathered are zeros, which only reach branches the
          per-slot selects discard.
      backbone2_fn, backbone_fn, apply_fn
          those of `slot_cfg_denoise_fns`: compaction changes how y_c / y_u
          are produced, never the per-slot policy steps.
    """
    forward_fn, _ = backbone_fns(params, cfg)
    backbone2_fn, backbone_fn, apply_fn = slot_cfg_denoise_fns(
        params, cfg, policy, cfg_policy)

    def compact_backbone_fn(xs, tvals, labels, nulls, null_vecs, null_mask,
                            txt, row_slot, row_uncond, row_dest):
        S, T, D = xs.shape
        yb = torch.where(row_uncond, nulls[row_slot], labels[row_slot])
        ce = _null_embed_rows(params, yb, null_vecs[row_slot],
                              row_uncond & null_mask[row_slot])
        kw = {}
        if txt:
            rows = row_slot + S * row_uncond.long()
            kw = {"txt_kv": (txt["k"][rows], txt["v"][rows]),
                  "txt_mask": txt["mask"][rows]}
        eps = forward_fn(xs[row_slot], tvals[row_slot], yb, y_embed=ce, **kw)
        buf = torch.zeros((2 * S + 1, T, D), dtype=eps.dtype, device=eps.device)
        buf[row_dest] = eps
        return buf[:S], buf[S:2 * S]

    return compact_backbone_fn, backbone2_fn, backbone_fn, apply_fn


class WantPlan(NamedTuple):
    """One tick's plan, before active masking: host (S,) arrays (see
    `core.policy.SlotWant`; `want_uncond` is the uncond policy's decision
    masked by the guided flag), and the signal on the device (None when the
    policy does not use one)."""
    want_cond: np.ndarray
    want_uncond: np.ndarray
    metric: np.ndarray
    value: np.ndarray
    threshold: np.ndarray
    forced: np.ndarray
    signal: Optional[torch.Tensor]


def slot_want_fns(params, cfg, policy: CachePolicy,
                  cfg_policy: Optional[CachePolicy] = None):
    """The planner's fused slot-batched want/metric pass.

      want_all_fn(states, steps, xs, tvals, labels, guided) -> WantPlan

    TeaCache's signal is computed ONCE over the whole (S, T, D) slot batch
    (only for a policy that uses it), then every slot's decision
    (`SlotWant`: want, the JAX `want_metric`, the value the decision
    thresholds, that threshold, and whether it was forced) comes out of
    `policy.want_slots` on the device.  The uncond decision comes from the
    host table of a step-only `cfg_policy` (all True without one), or else
    from its own `want_slots` on the device; either way it is masked by the
    guided flag.  Everything the device decided is packed into one tensor
    and read back in ONE device-to-host copy.  The signal stays on the
    device for the tick's `apply_fn`.

    The pass splits in two, so that the serving engine can capture the
    device half: `want_all_fn.device(states, steps, xs, tvals, labels) ->
    (packed (want_all_fn.rows, S) f32, signal)` makes no host read (a
    step-only cond policy's rows are its forced zeros there, its want row
    comes from the host in the read), and `want_all_fn.read(packed_host,
    steps, guided, signal) -> WantPlan` is the host half."""
    uncond = cfg_policy if cfg_policy is not None else NoCachePolicy()
    uncond_on_host = static_plan(uncond, 1) is not None
    cond_on_host = static_plan(policy, 1) is not None
    _, _, want_fn = slot_denoise_fns(params, cfg, policy)

    def device_fn(states, steps, xs, tvals, labels):
        dev = xs.device
        if cond_on_host:
            z = torch.zeros((xs.shape[0],), dtype=torch.float32, device=dev)
            rows, sig = [z, z, z, z, torch.ones_like(z)], None
        else:
            w, sig = want_fn(states["policy"], steps, xs,
                             to_device(tvals, dev), to_device(labels, dev))
            rows = [t.float() for t in w]
        if not uncond_on_host:
            rows.append(uncond.want_slots(states["cfg"], steps, xs).want
                        .float())
        return torch.stack(rows), sig

    def read(packed, steps, guided, signal):
        wc = policy.step_want(steps) if cond_on_host else packed[0] > 0.5
        wu = uncond.step_want(steps) if uncond_on_host else packed[5] > 0.5
        return WantPlan(wc, wu & np.asarray(guided, bool), packed[1],
                        packed[2], packed[3], packed[4] > 0.5, signal)

    def want_all_fn(states, steps, xs, tvals, labels, guided):
        packed, sig = device_fn(states, steps, xs, tvals, labels)
        return read(host_read(packed), steps, guided, sig)  # the priced read

    want_all_fn.device = device_fn
    want_all_fn.read = read
    want_all_fn.rows = 5 + (not uncond_on_host)
    return want_all_fn


def cfg_denoise_fn(params, cfg, cfg_scale: float, class_label: int = 0,
                   null_embed=None, text=None, neg_text=None):
    """Uncached CFG denoiser (the exact baseline): eps = e_u + s (e_c - e_u);
    `null_embed` (d_model,) replaces the null-class embedding with a
    negative-prompt vector.  `text` / `neg_text` (PromptEmbedding or
    (embed, mask); text-enabled configs) condition the cond / uncond branch
    through cross-attention, their K/V projected once here; a `neg_text`
    defaults `null_embed` to its pooled embedding."""
    forward_fn, _ = backbone_fns(params, cfg)
    dev = tree_device(params)
    txt = _as_text(text, cfg, dev)
    neg = _as_text(neg_text, cfg, dev)
    if null_embed is None and neg is not None:
        null_embed = _text_pooled(neg)
    ne = (None if null_embed is None
          else torch.as_tensor(null_embed, dtype=torch.float32))
    ops = ((None, None) if cfg.dit_text_len <= 0 else
           (_text_operands(params, cfg, txt, dev),
            _text_operands(params, cfg, neg, dev)))

    def fn(state, step, x, t_vec):
        B = x.shape[0]
        y_c = torch.full((B,), class_label, dtype=torch.long, device=x.device)
        e_c = forward_fn(x, t_vec, y_c, **_txt_kwargs(ops[0], B))
        if cfg_scale <= 0.0:
            return e_c, state
        y_u = torch.full((B,), cfg.dit_num_classes, dtype=torch.long,
                         device=x.device)
        ye = None if ne is None else ne.to(x.device)[None].expand(B, -1)
        e_u = forward_fn(x, t_vec, y_u, y_embed=ye, **_txt_kwargs(ops[1], B))
        return e_u + cfg_scale * (e_c - e_u), state
    return fn
