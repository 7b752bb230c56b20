"""Quickstart: end-to-end training of a reduced smollm-135m on synthetic
Markov data — real optimizer, checkpointing, restart, straggler monitor —
on the card, where every attention layer runs the ``flash_attention``
kernel forward under autograd.

    python examples_torch/quickstart.py [--steps 300]
    python examples_torch/quickstart.py --steps 20 --device cpu

Loss drops well below the uniform-entropy floor (log V ~= 4.85) because the
synthetic stream is an order-2 Markov chain with learnable structure.
"""
import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402


def main(argv=None) -> dict:
    """Trains, restarts from the last checkpoint, prints both and returns
    ``{"history", "final_loss", "tokens_per_s", "health", "restart"}``;
    raises unless the restart resumed at the trained step with the
    trained parameters."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                global_batch=8)
    with tempfile.TemporaryDirectory() as d:
        out = run_training(cfg, shape, args.steps, ckpt_dir=d,
                           ckpt_every=100, log_every=25,
                           device=args.device)
        print(f"\nfinal loss {out['final_loss']:.3f} "
              f"(uniform floor {np.log(cfg.vocab_size):.2f}); "
              f"{out['tokens_per_s']:.0f} tok/s; "
              f"health={out['health']}")
        # resume from the final checkpoint to show restartability
        saved = CheckpointManager(d).latest_step()
        out2 = run_training(cfg, shape, args.steps, ckpt_dir=d, quiet=True,
                            device=args.device)
        print(f"restart check: resumed at trained step, loss "
              f"{out2['final_loss']:.3f}")
    restart = {
        "saved_step": saved, "steps_rerun": len(out2["history"]),
        "params_equal": all(torch.equal(a, b) for a, b in zip(
            lm.tree_leaves(out["params"]), lm.tree_leaves(out2["params"])))}
    if restart != {"saved_step": args.steps, "steps_rerun": 0,
                   "params_equal": True}:
        raise RuntimeError(f"quickstart: the restart did not resume at the "
                           f"trained step: {restart}")
    return {"history": out["history"], "final_loss": out["final_loss"],
            "tokens_per_s": out["tokens_per_s"], "health": out["health"],
            "restart": restart}


if __name__ == "__main__":
    main()
