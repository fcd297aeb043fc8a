"""Tiny cells for the CPU tests: the harness's own serving and training loops on reduced Mamba2 models."""
from __future__ import annotations

import json

from bench.harness import cell as cellmod
from bench.harness.env import BENCH


def arch(compute_dtype: str = "bfloat16") -> dict:
    return {"name": "tiny-ssm", "family": "ssm", "num_layers": 2, "d_model": 64,
            "vocab_size": 256, "ssm_state": 16, "ssm_expand": 2, "ssm_head_dim": 16, "ssm_conv_width": 4,
            "ssm_chunk": 16, "norm_eps": 1e-5, "param_dtype": "float32", "compute_dtype": compute_dtype,
            "tie_embeddings": True, "attention_impl": "xla", "remat": True}


SERVE_MIX = {"kind": "serve", "batch": 2, "new_tokens": 5, "max_len": 140,
             "prompt": {"min": 32, "max": 128, "round": 16, "strata": 3}}
# limits for these tiny cells, between the bf16 program's readings and the float8 control's here
# (logit gap, seeds 1-3, 11, 13, 21-23: 0-0.0034 and 0.016-0.058; training, seeds 1-3,
# 12, 14: median-leaf gradient gap 0.0005-0.0015 and 0.0065-0.0123, widest change gap 0.003-0.017
# and 0.039-0.070; half of each batch left out reads 0.022-0.054 and 0.061-0.107)
SERVE_LIMITS = {"logit_gap": 0.01}
TRAIN_LIMITS = {"grad_gap": 0.004, "change_gap": 0.03}


def serve_cell(compute_dtype: str = "bfloat16") -> cellmod.Cell:
    config = {"name": "tiny-ssm", "reference": "mamba2_lm", "arch": arch(compute_dtype)}
    return cellmod.Cell("tiny-ssm.serve", 1, config, dict(SERVE_MIX), dict(SERVE_LIMITS), [], [])


def train_cell(compute_dtype: str = "bfloat16") -> cellmod.Cell:
    optimizer = json.loads((BENCH / "traffic" / "train-2k.json").read_text())["optimizer"]
    mix = {"kind": "train", "batch": 2, "seq_len": 32, "optimizer": optimizer}
    config = {"name": "tiny-ssm", "reference": "mamba2_lm", "arch": arch(compute_dtype)}
    return cellmod.Cell("tiny-ssm.train", 1, config, mix, dict(TRAIN_LIMITS), [], [])
