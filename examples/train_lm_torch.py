"""End-to-end training example on the PyTorch port: a ~100M-param
granite-family model for a few hundred steps with checkpointing and
fault-tolerant resume. The port of `examples/train_lm.py`; it runs on the
card unless ``--device`` says otherwise.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu \\
        --steps 20 --ckpt-dir build/train_lm_ckpt

(A true ~100M config: 8 layers x d512 x ff2048 x 8 heads, vocab 49155 ->
~78M backbone + embeddings. Reduce --steps for a smoke run; the run
resumes from the latest checkpoint in --ckpt-dir, so empty it for a
fresh one.)
"""

import argparse
import os
import tempfile

from repro_torch.configs import base as cb
from repro_torch.configs.base import get_config
from repro_torch.launch import train as train_cli


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no CPU fallback)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt_100m"))
    args = ap.parse_args(argv)

    # register a ~100M variant of the granite family for this example
    full = get_config("granite-3-2b")
    cfg100m = full.replace(
        num_layers=8, d_model=512, num_heads=8, num_kv_heads=4,
        head_dim=64, d_ff=2048, segments=())
    cb._REGISTRY["granite-100m"] = cfg100m
    cb._REDUCED["granite-100m"] = cfg100m

    return train_cli.main([
        "--arch", "granite-100m", "--reduced",
        "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "50",
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
