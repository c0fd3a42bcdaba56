"""One rank of the capture-mesh tests of ``tests/test_torch_capture_mesh.py``.

Run as ``python tests/_torch_capture_worker.py <workdir>`` with
``SPECFORGE_COORDINATOR``, ``SPECFORGE_NUM_PROCESSES`` and
``SPECFORGE_PROCESS_ID`` set, one process per rank, on the CPU over gloo.
It imports torch and the port only (no JAX). ``workdir/case.json`` names
the dense and the MoE target directories and the padded batch
(``batch.npz``); the rank writes ``rank<N>.pt``:

- ``dense``: the fsdp capture of the batch through
  ``OfflineCaptureRunner(mesh=...)`` in fp32 (aux, last), the embedding's
  lookup by rows against the whole table's, this rank's resident
  parameter bytes and gathered bytes, and the files it wrote of a ``run``
  over the batch's samples (only rank 0 may write);
- ``ep``: the EP capture of the MoE target in fp32 at full capacity and
  at a factor that fits, and the message of the runner's abort at a
  factor that overflows.
"""

import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from specforge_tpu_torch.models.target.transformer import (  # noqa: E402
    TargetConfig,
    load_target_params,
)
from specforge_tpu_torch.offline_capture import capture  # noqa: E402
from specforge_tpu_torch.parallel.multihost import shutdown  # noqa: E402


def main(workdir: str) -> None:
    case = json.load(open(os.path.join(workdir, "case.json")))
    batch = np.load(os.path.join(workdir, "batch.npz"))
    ids, mask = batch["ids"], batch["mask"]
    mesh = capture.build_capture_mesh(0, "cpu")
    rank = mesh.rank
    out = {"rank": rank, "transport": mesh.transport}

    written = []
    save = capture.save_feature_file

    def counted(path, *args, **kwargs):
        written.append(os.path.basename(path))
        return save(path, *args, **kwargs)

    capture.save_feature_file = counted
    layers = tuple(case["layers"])
    dense = case["dense"]
    tc = TargetConfig.from_file(dense)
    runner = capture.OfflineCaptureRunner(
        capture.OfflineCaptureConfig(dense, os.path.join(workdir, "files"),
                                     layers, ids.shape[1], ids.shape[0]),
        target_config=tc, mesh=mesh, device="cpu",
        target_params=load_target_params(dense, tc, torch.float32, "cpu",
                                         mesh=mesh))
    out["dense"] = runner._run_batch(ids, mask)
    # the embedding's rows, and the whole table NCCL ranks gather instead
    key, ids_t = "model.embed_tokens.weight", torch.as_tensor(ids)
    rows = runner.params.rows(key, ids_t)
    mesh.transport = "nccl"
    out["lookups_equal"] = torch.equal(runner.params.lookup(key, ids_t), rows)
    mesh.transport = "gloo"
    out["resident_bytes"] = runner.params.resident_bytes()
    out["gathered"] = dict(runner.params.gathered)
    samples = [{"input_ids": ids[j, :int(mask[j].sum())],
                "loss_mask": np.ones(int(mask[j].sum()), np.int64)}
               for j in range(ids.shape[0])]
    out["paths"] = [os.path.basename(p) for p in runner.run(samples)]
    out["written"] = written

    moe = case["moe"]
    tc = TargetConfig.from_file(moe)
    config = capture.OfflineCaptureConfig(moe, os.path.join(workdir, "moe"),
                                          layers, ids.shape[1], ids.shape[0])
    params = load_target_params(moe, tc, torch.float32, "cpu", mesh=mesh,
                                expert_parallel=True)
    out["ep_keys"] = {k: tuple(v.shape) for k, v in params.items()
                      if "experts" in k}
    for name, factor in (("ep", None), ("ep_fits", case["fits"]),
                         ("ep_overflows", case["overflows"])):
        runner = capture.OfflineCaptureRunner(
            config, target_config=tc, target_params=params, mesh=mesh,
            moe_impl="ep", moe_capacity_factor=factor)
        try:
            out[name] = runner._run_batch(ids, mask)
        except capture.CapacityOverflow as exc:
            out[name] = str(exc)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
