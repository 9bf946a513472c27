"""Serving entry: ``python -m idgrec_torch.serve --model=LightGCN
--dataset=yelp2018 --checkpoint_dir=ck --users=1,17,42 -k 10``
(counterpart of idgrec_tpu/serve.py).

Loads a training checkpoint written by
``train_model(checkpoint_dir=...)`` (or ``main.py --checkpoint_dir``) of
this package or of the JAX package, answers top-K requests through
`serving.Recommender`, and prints one JSON line per user:
``{"user": u, "items": [...], "scores": [...]}``. The flags are the JAX
package's, plus ``--device`` (default the card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="ID-GRec-Torch serving")
    parser.add_argument("--model", type=str, required=True, help="model name")
    parser.add_argument("--dataset", type=str, default=None,
                        help="override the config's dataset name")
    parser.add_argument("--dataset_path", type=str, default=None,
                        help="override the config's dataset root")
    parser.add_argument("--configure_dir", type=str, default=None,
                        help="directory of <model>.txt config files")
    parser.add_argument("--checkpoint_dir", type=str, required=True,
                        help="checkpoints written by training")
    parser.add_argument("--epoch", type=int, default=None,
                        help="serve a specific checkpoint epoch (default: latest)")
    parser.add_argument("--users", type=str, required=True,
                        help="comma-separated user ids, e.g. 1,17,42")
    parser.add_argument("-k", "--top_k", type=int, default=10)
    parser.add_argument("--include_seen", action="store_true",
                        help="do NOT filter items the user already interacted with")
    parser.add_argument("--topk_mode", default="exact", choices=["exact", "approx"],
                        help="approx ranks exactly in the port (the JAX package's "
                        "approx_max_k is a TPU op; exact top-k meets its recall target)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from idgrec_torch.config import load_model_config
    from idgrec_torch.data.dataset import Dataset
    from idgrec_torch.models import available_models
    from idgrec_torch.serving import Recommender

    if args.model not in available_models():
        print(f"error: unknown model {args.model!r}; available: "
              f"{', '.join(available_models())}", file=sys.stderr)
        return 2

    config = load_model_config(args.model, args.configure_dir)
    if args.dataset:
        config.set("dataset", args.dataset)
    if args.dataset_path:
        config.set("dataset_path", args.dataset_path)

    data_dir = os.path.join(config.str("dataset_path"), config.str("dataset"))
    data = Dataset.load(data_dir, name=config.str("dataset"))

    try:
        users = [int(u) for u in args.users.split(",") if u.strip() != ""]
    except ValueError:
        print(f"error: --users must be comma-separated integers, got "
              f"{args.users!r}", file=sys.stderr)
        return 2
    if not users:
        print("error: --users is empty", file=sys.stderr)
        return 2

    try:
        rec = Recommender.from_checkpoint(
            args.model, data, config, args.checkpoint_dir, epoch=args.epoch,
            device=args.device, filter_seen=not args.include_seen, topk_mode=args.topk_mode,
        )
    except FileNotFoundError as e:  # no checkpoint
        print(f"error: {e}", file=sys.stderr)
        return 2

    try:
        items, scores = rec.recommend(users, k=args.top_k)
    except ValueError as e:  # out-of-range ids, k > num_items
        print(f"error: {e}", file=sys.stderr)
        return 2
    for u, it, sc in zip(users, items, scores):
        print(json.dumps({
            "user": int(u),
            "items": [int(x) for x in it],
            "scores": [round(float(x), 6) for x in sc],
        }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
