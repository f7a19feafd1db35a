"""The port's server: prefill a batch of prompts, then batched
greedy decode through the split tiers.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --batch 4 --prompt-len 32 --gen 32

Counterpart of ``repro.launch.serve``, with the reference's flags and loop:
``default_cut_layer`` places the cut, ``model_init`` draws the model, the
prompt is fed by repeated ``model_decode_step`` calls (one token each, the
KV caches or RWKV states carried), then each new token is the greedy
``argmax`` over ``logits[:, -1, :vocab]``; the generation is timed with
``obs.timeline.fenced`` and reported in the reference's two ``[serve]``
lines. An RWKV model runs one WKV kernel launch (T = 1 from the carried
state) per layer per step. It runs on the card (``device="cuda"``, the
CLI's only device) unless a caller of ``serve`` asks for the CPU; nothing
falls back. Where it differs from the reference:

- the weights are drawn from a torch generator (seed 0) and the prompts
  from the port's own ``synthetic_tokens`` with a numpy generator seeded
  0, not threefry; parity tests feed ``generate`` the reference's weights
  and prompts instead;
- the decode step runs eagerly under ``torch.no_grad()``, with the caches
  written in place, where the reference ``jit``s a functional step.

``serve`` refuses an enc-dec config, as the reference's CLI does; such a
model is served by ``transcribe``: the steps of the reference's
``examples/whisper_serve.py`` (encoder prefill, ``enc_norm``, the
cross-attention's K/V written into the decode state, greedy decode from
token 0). A ``patch_embed`` config (pixtral-12b) is served text only, as
the reference's serve does.

Memory (bf16 weights; arithmetic from the configs, not a measurement):
rwkv6-7b is 15.0 GB and deepseek-moe-16b 32.2 GB whole, so both serve at
all their layers on one 80 GB card. A deepseek decode step routes B
tokens into C = max(4, ceil(B k 1.25 / E)) slots an expert (nothing drops)
and its batched expert matmuls read every expert's weights whatever the
routing (30.8 GB of its 27 MoE layers): with the rest, all 32.2 GB a step,
9.6 ms at 3.35 TB/s before host dispatch. One jamba-1.5-large-398b
super-block is 88.3 GB (82.3 GiB) and an arctic-480b MoE layer 26.8 GB:
neither serves at full width on one card; their reduced configs do.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..configs import ARCHS
from ..configs.base import ArchConfig
from ..data.synthetic import synthetic_tokens
from ..models.transformer import (Model, build_groups, decode_state_init,
                                  default_cut_layer, group_apply,
                                  model_decode_step, model_init)
from ..obs.timeline import fenced


@torch.no_grad()
def generate(cfg: ArchConfig, model: Model, prompts: torch.Tensor, gen: int,
             *, cut_layer: int, keep_logits: bool = False):
    """Greedy decode: prompts (B, P) token ids on the model's device, fed
    one decode step each from a fresh ``decode_state_init`` of length
    P + gen, then ``gen`` tokens, each the argmax over the last step's
    logits (the real vocab, not the padding) and fed back at the next
    position. Returns the (B, gen) int64 tokens, and with ``keep_logits``
    also every step's logits (B, P + gen, V_pad) in the model's dtype (the
    last step's, which the reference computes too, included)."""
    b, plen = prompts.shape
    max_len = plen + gen
    state = decode_state_init(cfg, b, max_len, cut_layer=cut_layer,
                              device=prompts.device)
    logits, kept = None, []
    for t in range(plen):
        logits, state = model_decode_step(cfg, model, state,
                                          prompts[:, t:t + 1], t,
                                          cut_layer=cut_layer)
        kept.append(logits)
    toks = []
    for t in range(plen, max_len):
        nxt = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)
        toks.append(nxt)
        logits, state = model_decode_step(cfg, model, state, nxt[:, None], t,
                                          cut_layer=cut_layer)
        kept.append(logits)
    tokens = (torch.stack(toks, dim=1) if toks
              else prompts.new_zeros((b, 0), dtype=torch.int64))
    if keep_logits:
        return tokens, torch.cat(kept, dim=1)
    return tokens


@torch.no_grad()
def transcribe(cfg: ArchConfig, model: Model, frames: torch.Tensor, gen: int,
               *, cut_layer: Optional[int] = None) -> torch.Tensor:
    """Enc-dec serving, the steps of the reference's
    ``examples/whisper_serve.py``: the encoder groups over ``frames`` (B,
    enc_seq_len, d) on the model's device (cast to the embedding's dtype;
    like the example, no position table is added, which ``model_forward``
    adds), ``enc_norm``, each ``xdec`` layer's cross-attention K/V of the
    encoder's output written into a fresh ``decode_state_init`` of length
    ``gen + 1``, then ``gen`` greedy steps from token 0, each token the
    argmax over the real vocab fed back at the next position. Returns the
    (B, gen) int64 tokens."""
    if not cfg.enc_dec:
        raise ValueError(f"transcribe serves an enc-dec config, not "
                         f"{cfg.name}")
    specs = build_groups(cfg, cut_layer=cut_layer)
    if specs != model.specs:
        raise ValueError(f"the model was built for groups {model.specs}, "
                         f"not {specs} (cut_layer={cut_layer})")
    b, senc = frames.shape[0], frames.shape[1]
    if senc != cfg.enc_seq_len:
        raise ValueError(f"frames of {senc} steps; the cross-attention's "
                         f"cache holds enc_seq_len={cfg.enc_seq_len}")
    enc_x = frames.to(model.embed.table.dtype)
    for g, layers in zip(specs, model.groups):
        if g.kind == "enc":
            enc_x, _ = group_apply(cfg, g, layers, enc_x, 0.0,
                                   positions=None, window=None)
    enc_out = model.enc_norm(enc_x)
    state = decode_state_init(cfg, b, gen + 1, cut_layer=cut_layer,
                              device=frames.device)
    kv = (b, senc, cfg.n_kv_heads, cfg.hd)
    for g, layers, gs in zip(specs, model.groups, state):
        if g.kind == "xdec":
            for li, layer in enumerate(layers):
                gs["ck"][li].copy_(layer.xattn["wk"](enc_out).reshape(kv))
                gs["cv"][li].copy_(layer.xattn["wv"](enc_out).reshape(kv))
    tok = torch.zeros((b, 1), dtype=torch.int64, device=frames.device)
    out = []
    for t in range(gen):
        logits, state = model_decode_step(cfg, model, state, tok, t,
                                          cut_layer=cut_layer)
        tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


def serve(cfg: ArchConfig, *, batch: int = 4, prompt_len: int = 32,
          gen: int = 32, client_fraction: float = 0.15, device="cuda",
          generator: torch.Generator | None = None,
          model: Model | None = None):
    """The reference's ``main`` after its flags: the model of ``cfg`` cut
    at ``client_fraction``, drawn from ``generator`` (default: seed 0 on
    ``device``) unless a ``model`` built for that cut is given, ``batch``
    synthetic prompts of ``prompt_len`` tokens from the generator's seed,
    ``gen`` tokens generated and timed. Prints the two ``[serve]`` lines
    and returns (tokens (B, gen), fenced wall seconds)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve(device='cuda') needs a CUDA device; pass "
                           "device='cpu' to run on the CPU")
    if cfg.enc_dec:
        raise SystemExit("use launch.serve.transcribe for enc-dec serving "
                         "(the reference serves it from "
                         "examples/whisper_serve.py)")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cut = default_cut_layer(cfg, client_fraction)
    if model is None:
        model = model_init(cfg, generator, cut_layer=cut, device=device)
    prompts = torch.from_numpy(synthetic_tokens(
        np.random.default_rng(generator.initial_seed()), batch, prompt_len,
        cfg.vocab)).long().to(device)
    out, dt = fenced(lambda: generate(cfg, model, prompts, gen,
                                      cut_layer=cut))
    tps = batch * (prompt_len + gen) / dt
    print(f"[serve] arch={cfg.name} batch={batch} prompt={prompt_len} "
          f"gen={gen} wall {dt:.2f}s ({tps:.1f} tok/s incl. prefill)")
    print(f"[serve] sample generations (first 10 ids): "
          f"{out[:, :10].tolist()}")
    return out, dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--client-fraction", type=float, default=0.15)
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    return serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                 gen=args.gen, client_fraction=args.client_fraction)[0]


if __name__ == "__main__":
    main()
