"""One rank of the two-process data-parallel check of
``tests/test_torch_dist.py`` (CPU, gloo; imports no JAX).

    python tests/_torch_dp_worker.py RANK WORLD HOST:PORT JOB OUT_DIR

``JOB`` (``torch.save``d by the test) holds the cases: a registry model,
its f64 weights (given to rank 0 only: the others get them through
``broadcast_module_``), the global batch, the step's keywords and the
optimizer's.  Each rank runs one data-parallel step of every case on its
slice of the batch (rows ``[rank * B / world, (rank + 1) * B / world)``,
as the JAX package's ``shard_map`` splits it), then one forward of a
stochastic model keyed as ``main --mode train`` keys a rank's step, and
writes ``OUT_DIR/rank<RANK>.pt``: the state dicts, the metrics and the
coin flips drawn.
"""

import sys

import torch


def main(rank: int, world: int, address: str, job: str, out: str) -> None:
    from scale_imagenet_tpu_torch.models import get_model
    from scale_imagenet_tpu_torch.ops.binarize import NoiseKey
    from scale_imagenet_tpu_torch.parallel import broadcast_module_, \
        initialize, rank_key
    from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
        make_robust_train_step, make_train_step

    torch.set_num_threads(1)
    rank, world, _ = initialize(address, world, rank, "cpu")
    spec = torch.load(job, weights_only=False)
    results = {}
    for case in spec["cases"]:
        md = get_model(case["name"], **case["kw"])
        model = md.init(device="cpu", dtype=torch.float64)
        if rank == 0:
            model.load_state_dict(case["state"], strict=True)
        broadcast_module_(model)
        opt, _ = make_optimizer(**spec["opt"])
        ts = TrainState(model, opt.init(dict(model.named_parameters())))
        if case["robust"]:
            step = make_robust_train_step(md, model, opt, **case["step"])
        else:
            step = make_train_step(model, opt, **case["step"])
        b = len(case["x"]) // world
        x = case["x"][rank * b:(rank + 1) * b]
        y = case["y"][rank * b:(rank + 1) * b]
        ts, metrics = step(ts, x, y)
        results[case["id"]] = {
            "state": model.state_dict(),
            "metrics": {k: float(v) for k, v in metrics.items()}}

    # a stochastic forward keyed as a rank's step: every draw recorded
    flips = []
    real = NoiseKey.draw

    def draw(key, x):
        out = real(key, x)
        flips.append(out)
        return out

    NoiseKey.draw = draw
    sto = spec["stochastic"]
    md = get_model(sto["name"], **sto["kw"])
    model = md.init(seed=0, device="cpu")
    key = rank_key(NoiseKey(sto["seed"]), rank, world).child("step0")
    with torch.no_grad():
        model(sto["x"], {}, noise=key)       # training mode, as a step
    results["flips"] = flips
    torch.save(results, f"{out}/rank{rank}.pt")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
