"""Quickstart: the two halves of the repo in ~60 seconds on CPU.

1. The paper's KV store: hybrid placement vs baselines on a mixed workload.
2. The training framework: a reduced assigned-architecture, a few steps.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The training half runs on the card unless ``--device cpu`` is given.
"""
import argparse

import torch

import repro_torch.api as api
from repro_torch.configs import ARCHS
from repro_torch.core import StoreConfig
from repro_torch.core.ycsb import Workload
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.models import get_model
from repro_torch.models.layers import _device
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_fn


def kv_store_demo() -> None:
    print("=== Parallax hybrid KV placement vs baselines (SD mix, scaled) ===")
    for mode in ("parallax", "rocksdb", "blobdb"):
        cfg = api.EngineConfig(store=StoreConfig(
            mode=mode, l0_capacity=1 << 14, growth_factor=4,
            cache_bytes=1 << 17, segment_bytes=1 << 17, chunk_bytes=1 << 13,
        ))
        with api.open(cfg) as db:
            api.execute(db, Workload("load_a", "SD", num_keys=4000, num_ops=0).load_ops())
            api.execute(db, Workload("run_a", "SD", num_keys=4000, num_ops=2000).run_ops())
            print(f"  {mode:9s} I/O amplification = {db.amplification():6.2f} "
                  f"(levels={[len(l) for l in db.store.levels]})")


def train_demo(device=None) -> None:
    print("=== Train a reduced qwen2.5 config for 20 steps ===")
    dev = _device(device)
    cfg = ARCHS["qwen2.5-3b"].reduced()
    model = get_model(cfg)
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw.init(params)
    step_fn = make_train_fn(cfg, adamw.AdamWConfig(lr=3e-3, warmup_steps=5))
    dcfg = DataConfig(seq_len=32, global_batch=4)
    for step in range(20):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host_batch(cfg, dcfg, step % 4).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        if step % 5 == 0 or step == 19:
            print(f"  step {step:3d} loss={float(metrics['loss']):.3f} "
                  f"lr={float(metrics['lr']):.2e}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    kv_store_demo()
    train_demo(args.device)
    print("done.")
