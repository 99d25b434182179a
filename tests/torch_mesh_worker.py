"""One rank of a data-parallel run of the port on the CPU (gloo), started
by tests/test_torch_mesh.py as a launcher would start it (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT in the environment).

    python tests/torch_mesh_worker.py step OUT INIT
        one train step of CNN8 under the mesh on this rank's rows of the
        batch in INIT (torch.save of a dict, see _step); writes
        OUT/rank<r>.pt with the rank's loss, accuracy and state_dict
    python tests/torch_mesh_worker.py graphs OUT INIT
        the programs that replay as CUDA graphs on an NCCL mesh, run here
        eagerly (gloo): the sharded evaluation (loop.Predictor, evaluate),
        the sharded extraction (features._extract_sharded) and one
        streamed step (loop.TrainStep on the rank's rows), cached and
        fused, from INIT (see _graphs); writes OUT/graphs_rank<r>.pt
    python tests/torch_mesh_worker.py cli OUT ARGS...
        tpu_breath_torch.cli.main(ARGS); each fit's final state_dict goes
        to OUT/<arch>_rank<r>.pt and each checkpoint save appends the
        saving rank to OUT/saves.txt
"""
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tpu_breath_torch import augment, cli  # noqa: E402
from tpu_breath_torch.config import DEFAULT_FEATURES, TrainCfg  # noqa: E402
from tpu_breath_torch.features import extract_features_batched  # noqa: E402
from tpu_breath_torch.models import layers, registry  # noqa: E402
from tpu_breath_torch.parallel import mesh as mesh_lib  # noqa: E402
from tpu_breath_torch.train import checkpoint as ckpt_lib  # noqa: E402
from tpu_breath_torch.train import loop  # noqa: E402


def _step(out: str, init: str) -> None:
    d = torch.load(init, weights_only=False)
    mesh = mesh_lib.make_mesh("cpu")
    cfg = TrainCfg(**d["cfg"])
    model = registry.build("cnn8", 36, dropout_rate=d["dropout"], bf16=False)
    model.load_state_dict(d["state"])
    opt = loop.make_optimizer(model, cfg)
    b = d["labels"].shape[0]
    lb = b // mesh.world
    rows = slice(mesh.rank * lb, (mesh.rank + 1) * lb)
    batch = augment.Batch(d["features"][rows], d["scalars"][rows],
                          d["labels"][rows])
    draws = None
    if d["aug"]:
        _, _, h, w = d["features"].shape
        draws = augment.draw(torch.Generator().manual_seed(d["aug_seed"]),
                             b, h, w, cfg.cutmix_alpha, cfg.mixup_alpha,
                             "cpu")
    layers.set_mesh(model, mesh)
    torch.manual_seed(d["drop_seed"])
    loss, acc = loop.train_step(model, opt, d["lr"], batch, cfg, draws, mesh)
    torch.save({"loss": float(loss), "acc": float(acc),
                "state": model.state_dict()},
               os.path.join(out, f"rank{mesh.rank}.pt"))
    torch.distributed.destroy_process_group()


def _streamed_step(d: dict, mesh) -> dict:
    """One call of a streamed TrainStep on this rank's rows of d["batch"]
    ((features, scalars, labels), or with d["fused"] (wavs, labels)), the
    augmentation drawn from a generator seeded d["aug_seed"] and gated by
    d["aug"], dropout from d["drop_seed"]."""
    cfg = TrainCfg(**d["cfg"])
    model = registry.build("cnn8", 36, dropout_rate=d["dropout"], bf16=False)
    model.load_state_dict(d["state"])
    opt = loop.make_optimizer(model, cfg)
    lb = cfg.batch_size // mesh.world
    batch = tuple(t[mesh.rank * lb:(mesh.rank + 1) * lb] for t in d["batch"])
    gen = torch.Generator().manual_seed(d["aug_seed"])
    step = loop.TrainStep(model, opt, None, cfg, gen,
                          DEFAULT_FEATURES if d["fused"] else None, mesh)
    layers.set_mesh(model, mesh)
    torch.manual_seed(d["drop_seed"])
    loss, acc = step(*batch, torch.tensor(d["lr"]), torch.tensor(d["aug"]))
    return {"loss": float(loss), "acc": float(acc),
            "state": model.state_dict()}


def _graphs(out: str, init: str) -> None:
    d = torch.load(init, weights_only=False)
    mesh = mesh_lib.make_mesh("cpu")
    e = d["eval"]
    model = registry.build("cnn8", 36, dropout_rate=0.0, bf16=False)
    model.load_state_dict(e["state"])
    predict = loop.Predictor(model, e["features"], e["scalars"],
                             e["batch_size"], mesh)
    res = {"logits": predict().numpy(),
           "metrics": loop.evaluate(predict, e["labels"])}
    x = d["extract"]
    res["features"], res["scalars"] = extract_features_batched(
        x["wavs"], chunk=x["chunk"], device="cpu", mesh=mesh)
    for name in ("cached", "fused"):
        res[name] = _streamed_step(d[name], mesh)
    torch.save(res, os.path.join(out, f"graphs_rank{mesh.rank}.pt"))
    torch.distributed.destroy_process_group()


def _cli(out: str, argv: list[str]) -> None:
    rank = os.environ["RANK"]
    fit, save = loop.fit, ckpt_lib.save

    def fit_and_keep(model, *args, **kwargs):
        result = fit(model, *args, **kwargs)
        arch = "vgg" if "VGG" in type(model).__name__ else "cnn8"
        torch.save(result.model.state_dict(),
                   os.path.join(out, f"{arch}_rank{rank}.pt"))
        return result

    def save_and_note(*args, **kwargs):
        with open(os.path.join(out, "saves.txt"), "a") as f:
            f.write(f"{rank}\n")
        return save(*args, **kwargs)

    loop.fit, ckpt_lib.save = fit_and_keep, save_and_note
    cli.main(argv)


if __name__ == "__main__":
    mode, out = sys.argv[1], sys.argv[2]
    os.makedirs(out, exist_ok=True)
    if mode == "step":
        _step(out, sys.argv[3])
    elif mode == "graphs":
        _graphs(out, sys.argv[3])
    else:
        _cli(out, sys.argv[3:])
