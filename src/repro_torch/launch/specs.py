"""Step builders and input specs for every (arch x input shape) (the JAX
package's `launch/specs.py`).

`build_case(arch, shape)` returns a `Case`:
  inputs        — the step's arguments as meta tensors (no storage)
  in_shardings  — mesh -> spec tree matching inputs (`sharding.py`)
  out_shardings — mesh -> spec tree of the outputs, or None
  build_fn      — mesh -> the step function over DTensor arguments
  notes         — adaptation notes (window, what a step returns)
  skip          — why the combination is skipped, or None

Shape semantics:
  train_4k     -> train step: forward + backward (remat per layer) of each
                  microbatch, gradients accumulated, clipped, AdamW
  prefill_32k  -> forward over the prompt; returns the last logits and the
                  per-layer K/V a decode cache is filled from
  decode_32k   -> ONE token against a seq_len KV cache (a DiT: one cached
                  denoise step, TaylorSeer N = 4)
  long_500k    -> decode at 524288: SSM / hybrid natively, dense / vlm /
                  moe with a sliding window of 8192, whisper skipped

The steps run under `implicit_replication()`: the plain tensors the
models make (positions, masks) count as replicated.  A prefill returns
`forward(collect_kv=True)`'s K/V, not `transformer.prefill`'s rolling
buffer: that buffer is built as a plain tensor at the global batch.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import sharding as shd
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.models import dit, encdec, param_count, params_shape, \
    transformer, video_dit
from repro_torch.optim import AdamWState, adamw_update, clip_by_global_norm
from repro_torch.train.steps import _value_and_grad
from repro_torch.tree import tree_map

LONG_WINDOW = 8192          # sliding window used by full-attention archs
BF16 = torch.bfloat16
META = torch.device("meta")


@dataclass
class Case:
    arch: str
    shape: str
    kind: str
    fn: Optional[Callable]          # step fn, or None when fn_builder set
    inputs: Dict[str, Any]
    in_shardings: Optional[Callable]    # mesh -> spec tree matching inputs
    out_shardings: Optional[Callable]   # mesh -> spec tree or None
    notes: str = ""
    skip: Optional[str] = None      # reason if the combination is skipped
    fn_builder: Optional[Callable] = None   # mesh -> fn (MoE EP needs mesh)

    def build_fn(self, mesh):
        return self.fn if self.fn_builder is None else self.fn_builder(mesh)


def _sds(shape, dtype):
    """A meta tensor: the shape and dtype of an input, no storage."""
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype, device=META)


def _params_specs(cfg):
    """The params tree of `cfg` on the meta device."""
    return params_shape(cfg)


def _moment_dtype(cfg):
    # giant MoEs keep moments in bf16 to fit HBM
    return BF16 if param_count(cfg) > 6e10 else torch.float32


def _ep_kwargs(mesh):
    """moe_forward_ep keyword arguments for a mesh (the expert-parallel
    production path)."""
    return dict(mesh=mesh, batch_ax=shd.batch_axes(mesh), ep_axis="data",
                inner_axes=("attn", "ffn"))


def _use_ep(cfg, batch: int, mesh_batch: int = 16) -> bool:
    """EP needs the (micro)batch to divide the data axis."""
    return cfg.is_moe and batch % (2 * mesh_batch) in (0, mesh_batch)


def effective_window(cfg, shape_name: str) -> int:
    """Attention window override for long_500k on full-attention archs."""
    if shape_name == "long_500k" and cfg.family in ("dense", "vlm", "moe"):
        return LONG_WINDOW
    return cfg.sliding_window


# ======================================================================
# train_4k
# ======================================================================

def ce_loss(logits, targets, vocab: int):
    """Mean cross-entropy, written for vocab-sharded logits: a max, a sum
    of exponentials and a masked sum over the vocab dim each reduce to one
    small collective (a gather of the target logit would gather the
    logits)."""
    lf = logits.float()
    m = lf.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
    hit = torch.arange(vocab, device=targets.device) == targets[..., None]
    tgt = (lf * hit).sum(-1)
    return (lse - tgt).mean()


def _encdec_loss(params, batch, cfg):
    logits = encdec.forward(params, batch["frames"], batch["tokens"], cfg)
    loss = ce_loss(logits, batch["targets"], cfg.vocab_size)
    return loss, {"loss": loss}


def _dit_forward(params, batch, cfg, remat=False):
    """The denoiser of an image / audio DiT, or a video DiT's (JAX's
    cases call the image DiT's forward on video params too; the video
    forward has no remat)."""
    if cfg.dit_num_frames > 0:
        return video_dit.forward(params, batch["latents"], batch["t"],
                                 batch["labels"], cfg)
    return dit.forward(params, batch["latents"], batch["t"],
                       batch["labels"], cfg, remat=remat)


def _dit_loss(params, batch, cfg):
    eps_hat = _dit_forward(params, batch, cfg, remat=True)
    loss = torch.mean(torch.square(eps_hat.float() - batch["eps"]))
    return loss, {"loss": loss}


def _lm_loss(params, batch, cfg, ep=None):
    logits, aux = transformer.forward(
        params, batch["tokens"], cfg, vision_embeds=batch.get("vision_embeds"),
        remat=True, ep=ep, with_aux=True)
    if cfg.family == "vlm":
        logits = logits[:, cfg.num_vision_tokens:]
    loss = ce_loss(logits, batch["targets"], cfg.vocab_size)
    total = (loss + 0.01 * aux["load_balance_loss"]
             + 1e-3 * aux["router_z_loss"])
    return total, {"loss": loss}


def _microbatch(batch, accum: int, m: int):
    """Rows m::accum of every input: under the batch sharding each rank's
    rows stay its own (a contiguous split would move rows across ranks)."""
    return {k: v.reshape((v.shape[0] // accum, accum) + tuple(v.shape[1:]))
            [:, m] for k, v in batch.items()}


def build_train_case(arch: str, cfg, ishape) -> Case:
    B, S = ishape.global_batch, ishape.seq_len
    mdt = _moment_dtype(cfg)
    n_params = param_count(cfg)
    # ZeRO-1: moments sharded over data above 10B; FSDP weights only for
    # the 100B+ MoEs (their expert weights already carry "data")
    FSDP_W = n_params > 60e9
    FSDP_M = n_params > 10e9

    if cfg.is_dit:
        inputs = {
            "latents": _sds((B, cfg.dit_patch_tokens, cfg.dit_in_dim), BF16),
            "t": _sds((B,), torch.float32),
            "labels": _sds((B,), torch.long),
            "eps": _sds((B, cfg.dit_patch_tokens, cfg.dit_in_dim),
                        torch.float32),
        }
        loss_fn = partial(_dit_loss, cfg=cfg)
        notes = "DiT trains on latent patches; seq_len means patch tokens"
    elif cfg.is_encoder_decoder:
        inputs = {
            "frames": _sds((B, cfg.encoder_seq, cfg.d_model), BF16),
            "tokens": _sds((B, S), torch.long),
            "targets": _sds((B, S), torch.long),
        }
        loss_fn = partial(_encdec_loss, cfg=cfg)
        notes = ("stub conv frontend: precomputed frame embeddings; no "
                 "remat (encdec.forward has none)")
    else:
        inputs = {"tokens": _sds((B, S), torch.long),
                  "targets": _sds((B, S), torch.long)}
        if cfg.family == "vlm":
            inputs["vision_embeds"] = _sds(
                (B, cfg.num_vision_tokens, cfg.vision_dim), BF16)
        loss_fn = partial(_lm_loss, cfg=cfg)
        notes = "remat per layer; logits sharded (batch, vocab)"

    # gradient accumulation: global batch 256 -> ACCUM microbatches, so
    # activation memory is bounded by one microbatch; >10B models halve
    # the microbatch again
    ACCUM_TARGET = 16 if n_params > 10e9 else 8

    def _pick_accum(mesh):
        """Largest accumulation <= target whose microbatch still divides
        the batch shards (multi-pod shards batch 32-way)."""
        shards = 1 if mesh is None else shd._axes_size(mesh,
                                                       shd.batch_axes(mesh))
        for a in (ACCUM_TARGET, 8, 4, 2, 1):
            if a <= ACCUM_TARGET and B % a == 0 and (B // a) % shards == 0:
                return a
        return 1

    def make_train_step(mesh=None, microbatches=None):
        """The step over `accum` microbatches; `microbatches` runs only
        the first few of them (the dry run traces 1 and 2 and extrapolates:
        every microbatch runs the same operators)."""
        accum = _pick_accum(mesh) if B % 16 == 0 else 1
        lfn = loss_fn
        if mesh is not None and cfg.is_moe:
            lfn = partial(loss_fn, ep=_ep_kwargs(mesh))

        def train_step(state, batch):
            params, opt = state
            with implicit_replication():
                grads, metrics = None, None
                for m in range(min(accum, microbatches or accum)):
                    mb = batch if accum == 1 else _microbatch(batch, accum, m)
                    g, mt = _value_and_grad(lfn, params, mb)
                    if grads is None:
                        grads, metrics = g, mt
                    else:
                        grads = tree_map(torch.add, grads, g)
                        metrics = {k: metrics[k] + mt[k] for k in metrics}
                if accum > 1:
                    grads = tree_map(lambda t: t * (1.0 / accum), grads)
                    metrics = {k: v * (1.0 / accum) for k, v in
                               metrics.items()}
                grads, gnorm = clip_by_global_norm(grads, 1.0)
                params, opt = adamw_update(grads, opt, params, lr=1e-4)
            return (params, opt), dict(metrics, grad_norm=gnorm)

        train_step.accum = accum
        return train_step

    pspec = _params_specs(cfg)
    mom = tree_map(lambda l: _sds(l.shape, mdt), pspec)
    state_spec = (pspec, AdamWState(step=_sds((), torch.int32), mu=mom,
                                    nu=mom))

    def _state_sharding(mesh):
        ps = shd.params_sharding(pspec, mesh, fsdp=FSDP_W)
        mu = shd.params_sharding(mom, mesh, fsdp=FSDP_M)
        return (ps, AdamWState(step=shd.replicated(mesh), mu=mu, nu=mu))

    def in_shardings(mesh):
        return (_state_sharding(mesh), shd.inputs_sharding(inputs, mesh))

    def out_shardings(mesh):
        metr = {"loss": shd.replicated(mesh),
                "grad_norm": shd.replicated(mesh)}
        return (_state_sharding(mesh), metr)

    return Case(arch=arch, shape=ishape.name, kind="train", fn=None,
                fn_builder=make_train_step,
                inputs={"state": state_spec, "batch": inputs},
                in_shardings=in_shardings, out_shardings=out_shardings,
                notes=notes)


# ======================================================================
# prefill_32k
# ======================================================================

def build_prefill_case(arch: str, cfg, ishape) -> Case:
    B, S = ishape.global_batch, ishape.seq_len
    window = effective_window(cfg, ishape.name)
    wcfg = dataclasses.replace(cfg, sliding_window=window)

    if cfg.is_dit:
        # diffusion "prefill" = one full denoiser forward over the batch
        inputs = {
            "latents": _sds((B, cfg.dit_patch_tokens, cfg.dit_in_dim), BF16),
            "t": _sds((B,), torch.float32),
            "labels": _sds((B,), torch.long),
        }

        def fn(params, batch):
            with implicit_replication():
                return _dit_forward(params, batch, cfg)
        notes = "DiT: denoiser forward (one diffusion step over the batch)"
    elif cfg.is_encoder_decoder:
        inputs = {
            "frames": _sds((B, cfg.encoder_seq, cfg.d_model), BF16),
            "tokens": _sds((B, S), torch.long),
        }

        def fn(params, batch):
            with implicit_replication():
                enc_out = encdec.encode(params, batch["frames"], cfg)
                logits = encdec.forward(params, batch["frames"],
                                        batch["tokens"], cfg)[:, -1]
                return logits, encdec.cross_kv(params, enc_out, cfg)
        notes = "prefill emits the decoder logits + exact cross-KV"
    else:
        inputs = {"tokens": _sds((B, S), torch.long)}
        if cfg.family == "vlm":
            inputs["vision_embeds"] = _sds(
                (B, cfg.num_vision_tokens, cfg.vision_dim), BF16)

        def fn(params, batch, ep=None):
            with implicit_replication():
                logits, kv = transformer.forward(
                    params, batch["tokens"], wcfg,
                    vision_embeds=batch.get("vision_embeds"),
                    collect_kv=True, ep=ep)
                return logits[:, -1], kv
        notes = (f"window={window or 'full'}; returns the per-layer K/V "
                 f"the decode cache is filled from")

    pspec = _params_specs(cfg)

    def in_shardings(mesh):
        return (shd.params_sharding(pspec, mesh),
                shd.inputs_sharding(inputs, mesh))

    fn_builder = None
    if cfg.is_moe and B % 16 == 0:
        def fn_builder(mesh, _fn=fn):
            return partial(_fn, ep=_ep_kwargs(mesh))
    return Case(arch=arch, shape=ishape.name, kind="prefill", fn=fn,
                fn_builder=fn_builder,
                inputs={"params": pspec, "batch": inputs},
                in_shardings=in_shardings, out_shardings=lambda m: None,
                notes=notes)


# ======================================================================
# decode (decode_32k / long_500k)
# ======================================================================

def build_decode_case(arch: str, cfg, ishape) -> Case:
    B, S = ishape.global_batch, ishape.seq_len
    window = effective_window(cfg, ishape.name)
    wcfg = dataclasses.replace(cfg, sliding_window=window)

    if cfg.is_dit:
        # diffusion has no token decode; serve_step = one cached denoise
        # step (the survey's own inference loop), cache = TaylorSeer's
        # difference stack; its refresh step runs here
        from repro_torch.core import make_policy
        policy = make_policy("taylorseer", interval=4, order=2)
        eps_shape = (B, cfg.dit_patch_tokens, cfg.dit_in_dim)
        state_spec = policy.init_state(eps_shape, BF16, device=META)
        inputs = {
            "latents": _sds(eps_shape, BF16),
            "t": _sds((B,), torch.float32),
            "labels": _sds((B,), torch.long),
        }

        def fn(params, state, batch, step=0):
            def compute(lat):
                return _dit_forward(params, dict(batch, latents=lat), cfg)
            with implicit_replication():
                return policy.apply(state, step, batch["latents"], compute)

        pspec = _params_specs(cfg)

        def in_shardings(mesh):
            return (shd.params_sharding(pspec, mesh),
                    shd.cache_sharding(state_spec, mesh),
                    shd.inputs_sharding(inputs, mesh))

        return Case(arch=arch, shape=ishape.name, kind="decode", fn=fn,
                    inputs={"params": pspec, "state": state_spec,
                            "batch": inputs},
                    in_shardings=in_shardings, out_shardings=lambda m: None,
                    notes="serve_step = cached denoise step (TaylorSeer N=4)")

    if cfg.is_encoder_decoder:
        if ishape.name == "long_500k":
            return Case(arch=arch, shape=ishape.name, kind="decode",
                        fn=None, inputs={}, in_shardings=None,
                        out_shardings=None,
                        skip="enc-dec ASR: a 512k decoder context is "
                             "architecturally meaningless")
        cache_len = S
        cache_spec = encdec.init_dec_cache(cfg, B, cache_len,
                                           cfg.encoder_seq, device=META)
        inputs = {"token": _sds((B,), torch.long),
                  "pos": _sds((B,), torch.long)}

        def fn(params, cache, batch):
            with implicit_replication():
                return encdec.decode_step(params, batch["token"],
                                          batch["pos"], cache, cfg)
        notes = f"decoder KV {cache_len} + exact cross-KV ({cfg.encoder_seq})"
    else:
        if ishape.name == "long_500k" and not (
                cfg.mamba_version > 0 or window > 0):
            return Case(arch=arch, shape=ishape.name, kind="decode", fn=None,
                        inputs={}, in_shardings=None, out_shardings=None,
                        skip="full attention at 512k is quadratic-prohibitive")
        cache_len = min(S, window) if window > 0 else S
        if cfg.family == "ssm":
            cache_len = 1  # state is O(1); no KV buffer
        cache_spec = transformer.init_cache(cfg, B, max(cache_len, 1),
                                            device=META)
        inputs = {"token": _sds((B,), torch.long),
                  "pos": _sds((B,), torch.long)}

        def fn(params, cache, batch, ep=None):
            with implicit_replication():
                return transformer.decode_step(params, batch["token"],
                                               batch["pos"], cache, wcfg,
                                               ep=ep)
        notes = (f"window={window or 'full'}, cache_len={cache_len}, "
                 f"pos up to {S}")

    pspec = _params_specs(cfg)

    def in_shardings(mesh):
        return (shd.params_sharding(pspec, mesh),
                shd.cache_sharding(cache_spec, mesh),
                shd.inputs_sharding(inputs, mesh))

    def out_shardings(mesh):
        return (shd.logits_sharding(mesh, ndim=2, batch=B,
                                    vocab=cfg.vocab_size),
                shd.cache_sharding(cache_spec, mesh))

    fn_builder = None
    if cfg.is_moe and not cfg.is_encoder_decoder and B % 16 == 0:
        def fn_builder(mesh, _fn=fn):
            return partial(_fn, ep=_ep_kwargs(mesh))
    return Case(arch=arch, shape=ishape.name, kind="decode", fn=fn,
                fn_builder=fn_builder,
                inputs={"params": pspec, "cache": cache_spec, "batch": inputs},
                in_shardings=in_shardings, out_shardings=out_shardings,
                notes=notes)


# ======================================================================

def build_case(arch: str, shape_name: str) -> Case:
    cfg = get_config(arch)
    ishape = INPUT_SHAPES[shape_name]
    if ishape.kind == "train":
        return build_train_case(arch, cfg, ishape)
    if ishape.kind == "prefill":
        return build_prefill_case(arch, cfg, ishape)
    return build_decode_case(arch, cfg, ishape)


__all__ = ["Case", "LONG_WINDOW", "effective_window", "ce_loss",
           "build_train_case", "build_prefill_case", "build_decode_case",
           "build_case"]
