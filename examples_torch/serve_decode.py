"""Batched serving demo: prefill a batch of prompts, decode with KV/state
caches (attention KV, Mamba conv+ssm, RWKV wkv state — whatever the arch
needs), on the card. The prefill teacher-forces the prompts through
decode steps, as the JAX package's ``serve_batch`` does, so this path
launches none of the port's kernels.

    python examples_torch/serve_decode.py --arch rwkv6-3b
    python examples_torch/serve_decode.py --arch rwkv6-3b --device cpu

With ``--ranks N`` the demo runs the DISTRIBUTED serve tier instead: a
router rank admits synthetic sessions through persistent-request pools
and N-1 workers decode them with continuous batching over the
rank-sharded KV page cache (pages move one-sidedly, as CUDA tensors
through the ``cellcopy`` kernel — see docs/serving.md).

    python examples_torch/serve_decode.py --ranks 3
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main(argv=None) -> dict:
    """Serves, prints the first row's tokens (or the tier's line) and
    returns ``{"tokens": [[...], ...], ...}`` from ``serve_batch``, or
    the router's report with ``launches_by_rank`` under ``--ranks``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--ranks", type=int, default=0,
                    help="> 1: distributed serve tier (router + workers)")
    ap.add_argument("--sessions", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.ranks > 1:
        from repro_torch.launch.serve import serve_distributed
        return serve_distributed(ranks=args.ranks, sessions=args.sessions,
                                 device=args.device)

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch.serve import serve_batch
    if args.arch not in ARCHS:
        ap.error(f"unknown arch {args.arch!r} (choose from {list(ARCHS)})")
    cfg = get_config(args.arch).reduced()
    out = serve_batch(cfg, batch=args.batch, prompt_len=args.prompt_len,
                      gen=args.gen, device=args.device)
    print("sampled token ids (first row):", out["tokens"][0][:16])
    return dict(out, tokens=out["tokens"].tolist())


if __name__ == "__main__":
    main()
