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

The enc-dec config is refused, as the reference refuses it.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import ARCHS
from ..configs.base import ArchConfig
from ..data.synthetic import synthetic_tokens
from ..models.transformer import (Model, decode_state_init,
                                  default_cut_layer, model_decode_step,
                                  model_init)
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
        raise SystemExit("enc-dec serving is not ported (the reference "
                         "serves it from examples/whisper_serve.py)")
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
