"""Serving example: batched prefill+decode with hybrid KV-cache placement.

Shows the paper's placement classes in action on the serving side: short
prompts land in the slab, medium in the transient arena (wholesale reclaim),
long in the paged pool (free-list GC).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse

import torch

from repro_torch.configs import ARCHS
from repro_torch.models import get_model
from repro_torch.models.layers import _device
from repro_torch.serve.engine import Request, ServeEngine


def main(device=None) -> None:
    dev = _device(device)
    cfg = ARCHS["qwen3-8b"].reduced()
    model = get_model(cfg)
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServeEngine(cfg, params, max_len=96, batch_size=4, device=dev)

    prompts = [
        torch.tensor([1, 5, 9, 2, 7, 3, 8, 4], dtype=torch.int32),
        torch.tensor([2, 4, 6, 8, 10, 12, 14, 16], dtype=torch.int32),
        torch.tensor([11, 3, 5, 7, 1, 9, 13, 2], dtype=torch.int32),
        torch.tensor([42, 17, 23, 5, 99, 100, 3, 8], dtype=torch.int32),
    ]
    reqs = [Request(i, p, max_new_tokens=12) for i, p in enumerate(prompts)]
    done = eng.run_batch(reqs)
    for r in done:
        print(f"seq {r.seq_id}: prompt={list(map(int, r.prompt))[:4]}... -> {r.output}")
    print("cache manager:", eng.cache_mgr.stats())


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(ap.parse_args().device)
