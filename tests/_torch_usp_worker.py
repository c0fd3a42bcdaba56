"""One rank of the multi-process USP tests of ``tests/test_torch_usp.py``.

Run as ``python tests/_torch_usp_worker.py <case> <workdir>`` with
``SPECFORGE_COORDINATOR``, ``SPECFORGE_NUM_PROCESSES`` and
``SPECFORGE_PROCESS_ID`` set, one process per rank, on the CPU over gloo. It
imports torch and the port only (no JAX): the test hands it numpy inputs
and weights through files in ``workdir`` and reads back one result file per
rank.

Cases:

- ``attention_and_model``: the USP TTT attention (forward, and the
  gradients of ``sum(out * dout)`` for q, k0 and v0) at each topology of
  ``attention.npz``, then ``OnlineEagle3Model`` under ``"usp"`` on the batch
  and weights of ``model.npz`` / ``model_state.pt``;
- ``train``: ``cli.main(["train", "-c", run.json, "--device", "cpu"])``,
  then this rank's trained weights and its IO roles;
- ``mesh``: the runs listed in ``runs.json``, one ``cli.main(["train",
  ...])`` each on the mesh its config asks for (dp, fsdp, USP), in order;
  a run may name an ``.npz`` of the uniform values JAX's sampler drew for
  each step's global batch (``anchors_<step>`` [B, S - 1], or
  ``cod_<step>`` [D - 1, B, S]), which replace the port's draws, each rank
  taking its batch block's rows. After each run: its weights gathered
  whole, the bytes of this rank's masters and optimizer state, its IO
  roles and place, into ``<name>_rank<N>.npz`` and ``.json``.
"""

import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from specforge_tpu_torch.parallel.mesh import MeshConfig, build_mesh  # noqa: E402
from specforge_tpu_torch.parallel.multihost import (  # noqa: E402
    maybe_initialize_distributed,
    process_index,
    shutdown,
)

CPU = torch.device("cpu")


def attention_and_model(workdir: str, rank: int) -> None:
    from specforge_tpu_torch.algorithms.eagle3.model import OnlineEagle3Model
    from specforge_tpu_torch.models.draft.llama_eagle3 import (
        Eagle3Config,
        LlamaEagle3Draft,
    )
    from specforge_tpu_torch.parallel.usp import (
        SequenceShard,
        usp_ttt_attention_local,
    )

    out = {}
    data = np.load(os.path.join(workdir, "attention.npz"))
    for cid in json.loads(str(data["cases"])):
        u, r = (int(x) for x in cid.split("_")[0].split("x"))
        mesh = build_mesh(MeshConfig(sp_ulysses=u, sp_ring=r), CPU)
        s = data[f"{cid}_q"].shape[2]
        s_loc = s // mesh.sp_size
        lo, hi = mesh.chunk_index * s_loc, (mesh.chunk_index + 1) * s_loc

        def chunk(name, axis=2):
            x = torch.from_numpy(np.ascontiguousarray(data[f"{cid}_{name}"]))
            return x.narrow(axis, lo, s_loc).contiguous()

        n = int(data[f"{cid}_n"])
        q = chunk("q").requires_grad_(True)
        keys = [chunk(f"k{i}").requires_grad_(i == 0) for i in range(n)]
        values = [chunk(f"v{i}").requires_grad_(i == 0) for i in range(n)]
        valid = chunk("valid", axis=1)
        res = usp_ttt_attention_local(mesh, q, keys, values, valid)
        dout = chunk("dout", axis=1)
        grads = torch.autograd.grad((res * dout).sum(),
                                    [q, keys[0], values[0]])
        out[f"{cid}_out"] = res.detach().numpy()
        for name, g in zip(("q", "k0", "v0"), grads):
            out[f"{cid}_d{name}"] = g.numpy()

    batch = np.load(os.path.join(workdir, "model.npz"))
    cfg = json.loads(str(batch["config"]))
    mesh = build_mesh(MeshConfig(sp_ulysses=2, sp_ring=2), CPU)
    draft = LlamaEagle3Draft(Eagle3Config(**cfg), dtype=torch.float32,
                             attention_backend="usp", device="cpu",
                             mesh=mesh)
    model = OnlineEagle3Model(draft, length=int(batch["length"]))
    model.load_state_dict(torch.load(os.path.join(workdir, "model_state.pt"),
                                     weights_only=True))
    # this rank's cut of the global batch, as the strategy takes it
    shard = SequenceShard.of(mesh, batch["input_ids"].shape[1],
                             model.length - 1)
    args = [shard.take(torch.from_numpy(batch[k])) for k in (
        "input_ids", "attention_mask", "loss_mask", "hidden_states",
        "target")]
    with torch.no_grad():
        ttt = model(*args, shard=shard)
    for name in ("plosses", "acceptance_rates", "metric_corrects",
                 "metric_denoms", "acceptance_denoms"):
        out[f"model_{name}"] = getattr(ttt, name).numpy()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


def train(workdir: str, rank: int) -> None:
    from specforge_tpu_torch import cli
    from specforge_tpu_torch.application import composition
    from specforge_tpu_torch.training.tracking import NoOpTracker

    built = []
    build = composition.build_training_run

    def capture(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    composition.build_training_run = capture
    rc = cli.main(["train", "-c", os.path.join(workdir, "run.json"),
                   "--device", "cpu"])
    trainer = built[0]
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **{
        name: p.detach().float().numpy()
        for name, p in trainer.state.params.items()})
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump({
            "rc": rc, "steps": trainer.state.step,
            "writes_checkpoints": trainer.checkpoints.primary,
            "tracks": not isinstance(trainer.tracker, NoOpTracker),
            "chunk": trainer.mesh.chunk_index,
            "transport": trainer.mesh.transport,
        }, f)


def _feed_uniforms(strategy, path: str) -> None:
    """Make ``strategy`` sample from the uniform values in ``path`` (JAX's
    draws for each step's global batch), keeping its block's rows."""
    from specforge_tpu_torch.algorithms.peagle.model import (
        cod_sample_from_uniform,
        document_ids_from_lengths,
    )
    from specforge_tpu_torch.ops.masks import anchors_from_uniform

    drawn = np.load(path)

    def rows(x, ctx, b):
        first = ctx.batch_block[0]
        return torch.from_numpy(x[..., first * b:(first + 1) * b, :])

    if hasattr(strategy, "sample_anchors"):
        def sample_anchors(loss_mask, ctx):
            rand = rows(drawn[f"anchors_{ctx.global_step}"], ctx,
                        loss_mask.shape[0])
            return anchors_from_uniform(rand, loss_mask,
                                        strategy.model.num_anchors)

        strategy.sample_anchors = sample_anchors
    else:
        def draw_sample(loss_mask, lengths, ctx):
            b, s = loss_mask.shape[:2]
            model = strategy.model
            return cod_sample_from_uniform(
                list(rows(drawn[f"cod_{ctx.global_step}"], ctx, b)),
                loss_mask.reshape(b, s),
                document_ids_from_lengths(lengths.reshape(b, -1), s),
                model.num_depths, model.down_sample_ratio,
                model.down_sample_ratio_min)

        strategy.draw_sample = draw_sample


def mesh(workdir: str, rank: int) -> None:
    from specforge_tpu_torch import cli
    from specforge_tpu_torch.application import composition
    from specforge_tpu_torch.parallel.fsdp import state_bytes
    from specforge_tpu_torch.training.tracking import NoOpTracker

    build = composition.build_training_run
    with open(os.path.join(workdir, "runs.json")) as f:
        runs = json.load(f)
    for run in runs:
        built = []

        def capture(*args, **kwargs):
            trainer = build(*args, **kwargs)
            if run.get("uniforms"):
                _feed_uniforms(trainer.strategy,
                               os.path.join(workdir, run["uniforms"]))
            built.append(trainer)
            return trainer

        composition.build_training_run = capture
        try:
            rc = cli.main(["train", "-c", os.path.join(workdir, run["config"]),
                           "--device", "cpu"])
        finally:
            composition.build_training_run = build
        trainer = built[0]
        shards = trainer.shards
        whole = {}
        for name, p in trainer.state.params.items():
            dim = shards.dim(name)
            whole[name] = (p if dim is None else shards.gather(p, dim)
                           ).detach().float().numpy()
        stem = os.path.join(workdir, f"{run['name']}_rank{rank}")
        np.savez(stem + ".npz", **whole)
        with open(stem + ".json", "w") as f:
            json.dump({
                "rc": rc, "steps": trainer.state.step,
                "writes_checkpoints": trainer.checkpoints.primary,
                "tracks": not isinstance(trainer.tracker, NoOpTracker),
                "coords": list(trainer.mesh.config.coords(rank)),
                "batch_block": list(trainer.mesh.batch_block),
                "transport": trainer.mesh.transport,
                "bytes": state_bytes(trainer.state),
                "dims": shards.dims,
            }, f)


CASES = {"attention_and_model": attention_and_model, "train": train,
         "mesh": mesh}


def main() -> None:
    case, workdir = sys.argv[1], sys.argv[2]
    maybe_initialize_distributed(CPU)
    try:
        CASES[case](workdir, process_index())
    finally:
        shutdown()


if __name__ == "__main__":
    main()
