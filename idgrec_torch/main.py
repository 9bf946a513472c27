"""Program entry: ``python -m idgrec_torch.main --model=LightGCN``
(counterpart of idgrec_tpu/main.py).

The same flags as the JAX package's CLI (--model, --seed, --seed_flag,
--dataset, --dataset_path, --configure_dir, --log_dir, --epochs,
--checkpoint_dir, --profile_dir, --mesh, --data_parallel), the same
numbered model menu when no model is given (without a terminal: the
listing and exit code 2 instead of a blocking prompt), per-model config
files in the same ``key = value`` format, the same log layout. One flag
more: ``--device`` (default the card; ``cpu`` runs the kernels' plain
versions).

``--mesh auto`` trains on every visible card: under a launcher that
sets ``RANK`` and ``WORLD_SIZE`` (``torchrun --nproc-per-node N -m
idgrec_torch.main ...``) the process joins the group; with more than one
visible card and no launcher, `main` starts one process a card itself.
The ranks lay out as a ("data", "model") mesh (``--data_parallel`` the
data axis; parallel/mesh.py): the model axis shards the tables and M,
and the data axis splits each step's batch, every data rank computing
the loss and backward of its rows alone. ``--mesh off``, or one card,
trains on one device.
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="ID-GRec-Torch")
    parser.add_argument("--seed_flag", type=bool, default=True, help="Fix random seed or not")
    parser.add_argument("--seed", type=int, default=2024, help="random seed for init")
    parser.add_argument("--model", type=str, default="unknown", help="model name")
    parser.add_argument("--dataset", type=str, default=None,
                        help="override the config's dataset name")
    parser.add_argument("--dataset_path", type=str, default=None,
                        help="override the config's dataset root")
    parser.add_argument("--configure_dir", type=str, default=None,
                        help="directory of <model>.txt config files")
    parser.add_argument("--log_dir", type=str, default="log")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override training_epochs")
    parser.add_argument("--checkpoint_dir", type=str, default=None,
                        help="save checkpoints and resume from the latest one")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of one epoch here")
    parser.add_argument("--mesh", type=str, default="auto", choices=["auto", "off"],
                        help="auto: shard over all visible cards when >1 (or the "
                             "launcher's ranks); off: single-device")
    parser.add_argument("--data_parallel", type=int, default=None,
                        help="data-axis width of the mesh: each data rank trains on "
                             "its 1/data_parallel of every batch")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def _rank_main(rank: int, argv, world: int, port: int) -> None:
    """One spawned rank: the launcher's environment, then `main`."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    code = main(argv)
    if code:
        raise SystemExit(code)


def main(argv=None) -> int:
    args = parse_args(argv)
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if args.mesh == "auto" and not launched and args.device in (None, "cuda"):
        import torch

        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count > 1:
            import torch.multiprocessing as mp

            from idgrec_torch.parallel.distributed import free_port
            from idgrec_torch.parallel.mesh import mesh_shape

            data, model = mesh_shape(count, args.data_parallel)
            print(f"--mesh auto: {count} visible cards, one process each on a "
                  f"{data}x{model} mesh")
            mp.spawn(_rank_main, args=(argv if argv is not None else sys.argv[1:],
                                       data * model, free_port()),
                     nprocs=data * model, join=True)
            return 0

    print("ID-GRec-Torch: the PyTorch/CUDA port of the framework for ID-based graph "
          "recommendation")
    print("-" * 100)

    import torch

    from idgrec_torch.config import load_model_config
    from idgrec_torch.data.dataset import Dataset
    from idgrec_torch.device import resolve_device
    from idgrec_torch.engine.loop import train_model
    from idgrec_torch.models import available_models

    models = available_models()
    if args.model == "unknown":
        print("Available models:")
        for i, name in enumerate(models, start=1):
            print(f"\t {i}. {name}")
        if sys.stdin.isatty():
            while True:
                selected = input("Please input the identifier or name of the model:")
                if selected in models:
                    args.model = selected
                    break
                try:
                    idx = int(selected)
                    if 1 <= idx <= len(models):
                        args.model = models[idx - 1]
                        break
                except ValueError:
                    pass
                print("Input Error. Please select from the list of implemented models.")
        else:
            print("error: pass --model=<NAME> (no interactive terminal)")
            return 2

    config = load_model_config(args.model, args.configure_dir)
    if args.dataset:
        config.set("dataset", args.dataset)
    if args.dataset_path:
        config.set("dataset_path", args.dataset_path)
    if args.epochs is not None:
        config.set("training_epochs", args.epochs)

    data_dir = os.path.join(config.str("dataset_path"), config.str("dataset"))
    print(f"Loading dataset from {data_dir} ...")
    data = Dataset.load(data_dir, name=config.str("dataset"))
    print(data.get_statistics())

    device = resolve_device(args.device)
    mesh = None
    if args.mesh == "auto" and launched:
        from idgrec_torch.parallel import distributed
        from idgrec_torch.parallel.mesh import make_mesh

        distributed.initialize(device=device)
        mesh = make_mesh(data_parallel=args.data_parallel, device=(
            torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda"
            else device))
        device = mesh.device
        print(f"mesh {mesh.data}x{mesh.model} (data x model), rank {mesh.rank}")

    seed = args.seed if args.seed_flag else None
    result = train_model(
        args.model,
        data,
        config=config,
        seed=seed,
        log_dir=args.log_dir,
        checkpoint_dir=args.checkpoint_dir,
        profile_dir=args.profile_dir,
        mesh=mesh,
        device=device,
    )
    if mesh is None or mesh.rank == 0:
        print("Best epoch:", result.best.epoch,
              "Best recall:", result.best.recall, "Best NDCG:", result.best.ndcg)
    if mesh is not None:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
