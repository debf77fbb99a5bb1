"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \\
        --steps 50 --batch 8 --seq-len 128 --device cpu

``--arch`` takes every arch of the registry; Whisper trains its decoder on
the encoder's output over seeded frame embeddings.  ``--device`` defaults to
the CUDA card.  Weights are random, from a seeded ``torch.Generator``;
``--checkpoint DIR`` writes ``DIR/step_<n>.npz`` every 100 steps and
``DIR/final.npz`` at the end, in the format the reference reads.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs import registry
from repro_torch.data import SyntheticLMStream
from repro_torch.device import resolve
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.train import train_loop


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=registry.list_archs())
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = registry.smoke(args.arch) if args.smoke else registry.get(args.arch)
    params = registry.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                                  device=dev)

    if registry.is_whisper(cfg):
        from repro_torch.models import whisper as W
        frames = torch.randn((args.batch, cfg.enc_frames, cfg.d_model), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(1))

        def forward(p, c, tokens):
            return W.decoder_forward(p, c, tokens, W.encode(p, c, frames))
    else:
        from repro_torch.models.transformer import forward

    stream = SyntheticLMStream(cfg.vocab_size, seed=0)
    cb = None
    if args.checkpoint:
        cb = lambda state, step: save_pytree(f"{args.checkpoint}/step_{step}.npz", state.params)
    state, hist = train_loop(params, forward, cfg, stream, steps=args.steps, batch=args.batch,
                             seq_len=args.seq_len, opt_cfg=AdamWConfig(lr=args.lr),
                             checkpoint_cb=cb, device=dev)
    if args.checkpoint:
        save_pytree(f"{args.checkpoint}/final.npz", state.params)
        print(f"saved {args.checkpoint}/final.npz")
    print(f"final loss: {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
