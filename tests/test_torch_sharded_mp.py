"""The port's process-group mesh route (parallel/sharded.make_mesh(group=))
in two processes on the CPU: a gloo group with a file:// rendezvous under
the test's tmp_path, each rank a process started with torch.multiprocessing
(spawn). The gates are those of the JAX package's
scripts/multiprocess_check.py; tests/torch_sharded_mp_worker.py runs them
and states them. The test has its own deadline, TIMEOUT_S: a rank that
hangs in a collective is terminated and the test fails.
"""

import json
import time

import torch.multiprocessing as mp

import torch_sharded_mp_worker as worker

TIMEOUT_S = 120


def test_two_process_gloo_mesh(tmp_path):
    ctx = mp.start_processes(
        worker.run, args=(2, str(tmp_path / "rendezvous"), str(tmp_path)),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]
    for r, res in enumerate(ranks):
        assert res["rank"] == r
        tile, sample = res["tile4"], res["sample2"]
        assert tile["mesh"] == {"tile": 4, "sample": 1}
        assert tile["cells"] == [2 * r, 2 * r + 1]
        assert tile["shape"] == [worker.H, worker.W, 3]
        assert tile["bitwise"] and tile["max_abs_diff"] == 0.0
        assert sample["mesh"] == {"tile": 1, "sample": 2}
        assert sample["cells"] == [r]            # the split crosses ranks
        assert sample["max_ulp"] <= 1
        assert tile["identical"] and sample["identical"]
        step = res["train_step"]
        assert step["loss_rel_diff"] <= 1e-5 and step["params_close"]
        assert step["params_identical"]
    assert ranks[0]["train_step"]["loss_mesh"] == \
        ranks[1]["train_step"]["loss_mesh"]
