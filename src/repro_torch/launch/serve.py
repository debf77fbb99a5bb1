"""Serving launcher of the port: batched decode through the KVSwap engine.

* ``--engine disk``   — the paper's runtime: KV on disk, grouped prediction,
  reuse buffer, modeled Jetson+NVMe/eMMC timing (:mod:`repro_torch.core`).
* ``--engine device`` — the full-cache device path of the reference
  (``serving/decode.py``) is not ported yet and raises.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --smoke \\
        --engine disk --prompt-len 96 --gen-len 32

``--arch`` takes every arch of the registry except ``whisper-large-v3`` and
``xlstm-1.3b`` (dense, MoE and the hybrid).  ``--device`` defaults to the
CUDA card; pass ``--device cpu`` to run on the CPU.  Weights are random,
from a seeded ``torch.Generator``.
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

    if args.engine == "device":
        raise NotImplementedError(
            "--engine device needs the full-cache serve path (serving/decode.py), which "
            "is not ported to repro_torch yet; it comes with a later slice of the port "
            "(see ROADMAP.md)")
    from repro_torch.core.engine import EngineConfig, KVSwapEngine

    dev = resolve(args.device)
    cfg = registry.smoke(args.arch) if args.smoke else registry.get(args.arch)
    params = registry.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                                  device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    max_len = args.prompt_len + args.gen_len + args.group_size
    calib = rng.standard_normal((1024, cfg.n_kv_heads, cfg.head_dim))
    ecfg = EngineConfig(group_size=args.group_size, n_select=args.n_select,
                        rank=args.rank, reuse_capacity=4 * args.n_select,
                        max_seq=max_len, disk=args.disk)
    t0 = time.time()
    with KVSwapEngine(registry.build_adapter(cfg), params, ecfg, batch=args.batch,
                      calib_k=calib, device=dev) as eng:
        out = eng.generate(prompts, args.gen_len)
        print(f"tokens:\n{out}")
        print(f"wall ({dev})               : {time.time() - t0:.1f}s")
        print(f"reuse ratio               : {eng.reuse_ratio():.2f}")
        print(f"modeled {args.disk} throughput: {eng.simulated_throughput():.1f} tok/s")
    return out


if __name__ == "__main__":
    main()
