"""Serving launcher: `python -m repro_torch.launch.serve --arch <id> [...]`.

Runs the batched engine with hybrid KV-cache placement on synthetic request
streams and reports throughput + cache-manager placement stats, for the
reduced config of any ``--arch`` of the registry (every family).  Runs on the
card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.models import get_model
from repro_torch.models.layers import _device
from repro_torch.serve.engine import Request, ServeEngine


@torch.inference_mode()
def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=sorted(ARCHS))
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = _device(args.device)
    cfg = ARCHS[args.arch].reduced()
    model = get_model(cfg)
    params = model.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    eng = ServeEngine(cfg, params, max_len=args.max_len, batch_size=args.batch_size, device=device)
    rng = np.random.default_rng(0)

    t0 = time.time()
    total = 0
    sid = 0
    for b in range(args.batches):
        reqs = []
        for _ in range(args.batch_size):
            prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, args.prompt_len), dtype=torch.int32)
            reqs.append(Request(sid, prompt, max_new_tokens=args.new_tokens))
            sid += 1
        done = eng.run_batch(reqs)
        total += sum(len(r.output) for r in done)
        print(f"batch {b}: generated {sum(len(r.output) for r in done)} tokens; "
              f"cache={eng.cache_mgr.stats()}", flush=True)
    dt = time.time() - t0
    print(f"throughput: {total/dt:.1f} tok/s ({total} tokens in {dt:.1f}s)")


if __name__ == "__main__":
    main()
