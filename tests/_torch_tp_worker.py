"""One rank of the two-process tensor-parallel check of
``tests/test_torch_tp_dist.py`` (CPU, gloo, a 1x2 mesh; imports no JAX).

    python tests/_torch_tp_worker.py RANK WORLD HOST:PORT JOB OUT_DIR

``JOB`` (``torch.save``d by the test) holds three cases, each a registry
model's f64 state dict and a batch: ``conv`` (the TP eval step's metrics),
``lut`` (the TP ``--lut`` step's, from the whole model's tables sliced to
this rank) and ``train`` (two TP train steps with ``accum`` and the EMA,
then the gathered train state).  Every rank reads the whole batch (one
data index).  Writes ``OUT_DIR/rank<RANK>.pt``: the metrics, each step's,
this rank's local state dict and, from every rank, the gathered payload.
"""

import sys

import torch


def main(rank: int, world: int, address: str, job: str, out: str) -> None:
    from scale_imagenet_tpu_torch.compile.lut_eval import compile_ttnet_lut
    from scale_imagenet_tpu_torch.models import get_model
    from scale_imagenet_tpu_torch.parallel import initialize
    from scale_imagenet_tpu_torch.parallel.mesh import make_mesh
    from scale_imagenet_tpu_torch.parallel.tp import gather_train_payload, \
        shard_luts, shard_model, shard_train_state, tp_lut_apply
    from scale_imagenet_tpu_torch.train import TrainState, make_eval_step, \
        make_optimizer, make_train_step, params_ema

    torch.set_num_threads(1)
    rank, world, _ = initialize(address, world, rank, "cpu")
    mesh = make_mesh(1, world, world, rank)
    spec = torch.load(job, weights_only=False)

    def whole(case):
        model = get_model(case["name"], **case["kw"]).init(
            device="cpu", dtype=torch.float64)
        model.load_state_dict(case["state"], strict=True)
        return model

    def local_of(model):
        return shard_model(model, mesh["model"], mesh.model_index,
                           mesh.model_group)

    def metrics(apply, case):
        m = make_eval_step(apply)(case["x"], case["y"])
        return {k: float(v) for k, v in m.items()}

    results = {}
    case = spec["conv"]
    results["conv"] = metrics(local_of(whole(case)), case)

    case = spec["lut"]
    model = whole(case)
    local = local_of(model)
    luts = shard_luts(compile_ttnet_lut(model), local)
    results["lut"] = metrics(lambda x: tp_lut_apply(luts, local, x), case)

    case = spec["train"]
    model = whole(case)
    opt, _ = make_optimizer(**spec["opt"])
    opt = type(opt)(opt.schedule, opt.momentum, opt.weight_decay,
                    params_ema(spec["ema"]))
    local, opt_state = shard_train_state(
        model, opt.init(dict(model.named_parameters())), mesh)
    ts = TrainState(local, opt_state)
    step = make_train_step(local, opt, accum=case["accum"],
                           group=mesh.data_group)
    results["train"] = []
    with torch.enable_grad():
        for _ in range(case["steps"]):
            ts, m = step(ts, case["x"], case["y"])
            results["train"].append({k: float(v) for k, v in m.items()})
    results["local"] = {k: v.clone() for k, v in local.state_dict().items()}
    results["payload"] = gather_train_payload(ts, mesh)
    torch.save(results, f"{out}/rank{rank}.pt")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
