"""Serving launcher of the port: batched decode through either serving path.

* ``--engine disk``   — the paper's runtime: KV on disk, grouped prediction,
  reuse buffer, modeled Jetson+NVMe/eMMC timing (:mod:`repro_torch.core`).
* ``--engine device`` — the full cache in device memory with KVSwap's
  selected attention (:mod:`repro_torch.serving.decode`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --smoke \\
        --engine disk --prompt-len 96 --gen-len 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b --smoke \\
        --engine device --device cpu

``--arch`` takes every arch of the registry.  Whisper's encoder runs on
seeded frame embeddings.  An arch without a KV layer (xLSTM) has nothing
for the disk engine to offload, and ``--engine disk`` refuses it.
``--device`` defaults to the CUDA card; pass ``--device cpu`` to run on the
CPU.  Weights are random, from a seeded ``torch.Generator``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve


def main(argv: list[str] | None = None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=registry.list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", choices=("disk", "device"), default="disk")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--disk", choices=("nvme", "ufs", "emmc"), default="nvme")
    ap.add_argument("--group-size", type=int, default=4)
    ap.add_argument("--n-select", type=int, default=8)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = registry.smoke(args.arch) if args.smoke else registry.get(args.arch)
    if args.engine == "disk" and not registry.is_whisper(cfg) and not cfg.kv_layers:
        raise ValueError(f"--engine disk: {cfg.name} has no KV layer (blocks "
                         f"{sorted(set(cfg.blocks))}), so there is no KV cache to offload; "
                         "serve it with --engine device")
    params = registry.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                                  device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    max_len = args.prompt_len + args.gen_len + args.group_size

    enc_out = None
    if registry.is_whisper(cfg):
        from repro_torch.models import whisper as W
        frames = torch.randn((args.batch, cfg.enc_frames, cfg.d_model), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(1))
        enc_out = W.encode(params, cfg, frames)

    if args.engine == "disk":
        from repro_torch.core.engine import EngineConfig, KVSwapEngine
        model = registry.build_adapter(cfg)
        if enc_out is not None:
            model.set_encoder_output(params, enc_out)
        calib = rng.standard_normal((1024, cfg.n_kv_heads, cfg.head_dim))
        ecfg = EngineConfig(group_size=args.group_size, n_select=args.n_select,
                            rank=args.rank, reuse_capacity=4 * args.n_select,
                            max_seq=max_len, disk=args.disk)
        t0 = time.time()
        with KVSwapEngine(model, params, ecfg, batch=args.batch, calib_k=calib,
                          device=dev) as eng:
            out = eng.generate(prompts, args.gen_len)
            print(f"tokens:\n{out}")
            print(f"wall ({dev})               : {time.time() - t0:.1f}s")
            print(f"reuse ratio               : {eng.reuse_ratio():.2f}")
            print(f"modeled {args.disk} throughput: {eng.simulated_throughput():.1f} tok/s")
        return out

    from repro_torch.serving import decode as D
    scfg = D.KVSwapServeConfig(group_size=args.group_size, n_select=args.n_select,
                               rank=args.rank)
    params = D.attach_kvswap_adapters(params, cfg, args.rank,
                                      generator=torch.Generator(device=dev).manual_seed(2))
    cache = D.init_cache(cfg, args.batch, max_len, kvswap=scfg, device=dev)
    logits, cache = D.prefill(params, cfg, torch.as_tensor(prompts, device=dev), cache,
                              kvswap=scfg, enc_out=enc_out)
    toks = []
    t0 = time.time()
    for _ in range(args.gen_len):
        nxt = logits.argmax(-1)[:, None]
        toks.append(nxt[:, 0])
        logits, cache = D.serve_step(params, cfg, nxt, cache, kvswap=scfg, enc_out=enc_out)
    out = torch.stack(toks, 1).cpu().numpy()
    dt = time.time() - t0
    print(f"tokens:\n{out}")
    print(f"device path ({dev}): {args.gen_len * args.batch / dt:.1f} tok/s")
    return out

if __name__ == "__main__":
    main()
