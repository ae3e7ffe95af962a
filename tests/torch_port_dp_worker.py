"""One rank of the port's data-parallel train step on the CPU, for
``tests/test_torch_port_parallel.py``: imports torch and the port only.

    python tests/torch_port_dp_worker.py RANK WORLD TCP_PORT DP_IMPL IN_PATH OUT_PATH

``IN_PATH`` (``torch.save``): the model's state dict and config, the loss
config, the learning rate and weight decay, the host's train batch and
val batch (numpy). The rank joins a ``gloo`` group on
``tcp://127.0.0.1:TCP_PORT``, takes its contiguous share of the train batch
(``parallel.mesh.split_batch``), runs the eval step on its share of the
val batch padded to the ranks (``pad_batch_to_multiple``), then one
``data_parallel`` Adam step in the form ``DP_IMPL``, and
``reduce_scalars_across_hosts`` of ``{"rank": rank + 1}``. Rank 0 writes
the scalars, the averaged gradients, the parameters and buffers after the
step, the val scalars and the reduced dict to ``OUT_PATH``.
"""

from __future__ import annotations

import sys

import torch
import torch.distributed as dist


def main(rank: int, world: int, port: int, dp_impl: str, in_path: str, out_path: str) -> None:
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import (
        LossConfig,
        ModelConfig,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
        batch_to_torch,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.parallel import (
        data_parallel,
        pad_batch_to_multiple,
        reduce_scalars_across_hosts,
        split_batch,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.step import (
        make_eval_step,
        make_optimizer,
        make_train_step,
    )

    torch.set_num_threads(2)
    spec = torch.load(in_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        model = MVS4Net(ModelConfig(**spec["cfg"]), device="cpu")
        model.load_state_dict(spec["state_dict"])
        opt = make_optimizer(model, spec["wd"])
        step = make_train_step(model, LossConfig(**spec["loss"]), opt, lambda i: spec["lr"])
        data_parallel(step, dp_impl)
        val = pad_batch_to_multiple(spec["val"], world)
        eval_step = make_eval_step(model, LossConfig(**spec["loss"]),
                                   group=step.dp.group)
        val_scalars = eval_step(batch_to_torch(split_batch(val, rank, world), "cpu"))
        grads = {}
        opt.register_step_pre_hook(lambda o, a, k: grads.update(
            {n: p.grad.clone() for n, p in model.named_parameters()}))
        scalars = step(batch_to_torch(split_batch(spec["train"], rank, world), "cpu"))
        reduced = reduce_scalars_across_hosts({"rank": rank + 1.0})
        if rank == 0:
            torch.save({
                "scalars": {k: v.item() for k, v in scalars.items()},
                "grads": grads,
                "state_dict": {k: v.clone() for k, v in model.state_dict().items()},
                "val_scalars": {k: v.item() for k, v in val_scalars.items()},
                "reduced": reduced,
            }, out_path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]), int(a[1]), int(a[2]), a[3], a[4], a[5])
