"""One rank of ``python -m scale_imagenet_tpu_torch.main`` for
``tests/test_torch_dist_cli.py`` (imports no JAX).

    python tests/_torch_main_rank.py JOBS

``JOBS`` (JSON) lists this rank's ``main`` runs, done in order in this
one process: each ``{"argv": [...], "env": {...}, "save_model": F,
"resume_under": D}`` (all but ``argv`` optional; ``resume_under`` adds
``--ckpt`` of the ``last`` checkpoint of the one run under ``D``, which an
earlier job wrote).  A job's ``env`` is set
for it alone (torchrun's variables), and each job joins its own process
group, left again before the next.  Each job's output follows a line
``JOB i``; its result is printed as JSON on a line ``RESULT ...``, and
``save_model`` also writes the trained model's state dict to ``F``.
Torch runs at one thread.  The metrics logs go to ``metrics.jsonl``
alone: TensorBoard's import takes seconds and is not what the tests hold.
"""

import json
import os
import sys

import torch


def main(jobs: str) -> None:
    import torch.distributed as dist

    from scale_imagenet_tpu_torch import main as cli

    sys.modules["torch.utils.tensorboard"] = None
    torch.set_num_threads(1)
    models = []
    real = cli.TrainState

    def capture(model, *a, **k):
        models.append(model)
        return real(model, *a, **k)

    cli.TrainState = capture
    for i, job in enumerate(json.loads(open(jobs).read())):
        print(f"JOB {i}", flush=True)
        env = job.get("env", {})
        os.environ.update(env)
        argv = job["argv"]
        if job.get("resume_under"):
            root = job["resume_under"]
            runs = [d for d in os.listdir(root)
                    if d not in ("best", "best.json")]
            assert len(runs) == 1, runs
            argv = argv + ["--ckpt", os.path.join(root, runs[0], "last")]
        try:
            out = cli.main(argv)
        finally:
            for k in env:
                del os.environ[k]
            if dist.is_initialized():
                dist.destroy_process_group()
        if job.get("save_model"):
            torch.save(models[-1].state_dict(), job["save_model"])
        print("RESULT " + json.dumps(out, default=str), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
