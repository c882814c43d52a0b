"""Data parallelism of the port (``gm3d_tpu_torch/parallel``) on the CPU.

Two gloo ranks, spawned once for the module (``_torch_dp_worker.py``), run
each scenario with small models on their rows of the same global batches;
this process runs the same scenarios as one process on the whole batches.
The single-process path is held against the JAX package by the other
``test_torch_port_*`` files. Bounds: the two ranks' metrics agree with each
other to rel 1e-6 and with one process to rel 2e-4 (the JAX package's
cross-layout bound, ``tests/test_multihost.py``); BatchNorm running
variances to rel 2e-3, running means to 2e-3 of the layer's spread (a mean
near zero is a cancellation, whose last digits follow the weights' rounding);
masks, gathered features and few-shot accuracies exactly.

In this process, without a process group: the lockstep draws (a rank's rows
of every draw equal the single-process draw's), ``shard_eval_batch`` on a
ragged batch, ``--num_devices`` against the world size, and the fan-out
server against the one-device server.
"""

import fcntl
import json
import os
import socket
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import _torch_dp_worker as worker
from _torch_threads import torch_at_one_thread  # noqa: F401  (this process at one thread, as the ranks)
from cli_harness import _reset_gm3d_loggers
from gm3d_tpu_torch.cli.common import rank_block
from gm3d_tpu_torch.cli.pretrain import step_draws
from gm3d_tpu_torch.masking import block_mask, random_mask
from gm3d_tpu_torch.models.blocks import drop_path
from gm3d_tpu_torch.models.point_transformer import PointTransformer
from gm3d_tpu_torch.models.segmentation import PointMAESeg
from gm3d_tpu_torch.parallel import context
from gm3d_tpu_torch.parallel.mesh import (
    make_mesh,
    run_eval_batch,
    shard_batch,
    shard_eval_batch,
)
from gm3d_tpu_torch.train.finetune import finetune_draws, vote_draws
from gm3d_tpu_torch.train.pretrain import probe_draws
from gm3d_tpu_torch.train.segmentation import seg_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _compute_runs(out):
    """Start both ranks, run this process's scenarios while they run, then
    collect the ranks' results. A rank that hangs is killed at the timeout
    and fails the tests that read these results, not the suite's clock."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
               OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "_torch_dp_worker.py"),
                               str(r), "2", str(port), str(out)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        assert context.get_context() is None
        _reset_gm3d_loggers()
        try:
            one = out / "one"
            one.mkdir()
            single = worker.run_all(str(one))
        finally:
            _reset_gm3d_loggers()
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)], single


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and this process's, computed once a test session:
    under pytest-xdist the workers share one copy through a file under the
    session's common temporary directory, taken under a lock."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _compute_runs(tmp_path_factory.mktemp("dp"))
    shared = tmp_path_factory.getbasetemp().parent
    with open(shared / "torch_dp_runs.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = shared / "torch_dp_runs.pt"
        if not done.exists():
            out = shared / "torch_dp_runs"
            out.mkdir()
            torch.save(_compute_runs(out), done)
        return torch.load(done, weights_only=False)


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def single(runs):
    return runs[1]


def _check_metrics(name, ranks, single):
    r0, r1, one = ranks[0][name], ranks[1][name], single[name]
    assert len(r0["metrics"]) == len(one["metrics"]) == worker.STEPS
    for m0, m1, m in zip(r0["metrics"], r1["metrics"], one["metrics"]):
        assert m0.keys() == m.keys()
        for key in m:
            np.testing.assert_allclose(m0[key], m1[key], rtol=1e-6, err_msg=key)
            np.testing.assert_allclose(m0[key], m[key], rtol=2e-4, atol=1e-6, err_msg=key)


def _check_bn(name, ranks, single):
    one = single[name]["bn"]
    assert one
    for r in ranks:
        bn = r[name]["bn"]
        assert bn.keys() == one.keys()
        for key, value in one.items():
            if key.endswith("running_var"):
                np.testing.assert_allclose(bn[key], value, rtol=2e-3, err_msg=key)
            else:
                spread = np.sqrt(one[key.replace("running_mean", "running_var")]).max()
                np.testing.assert_allclose(bn[key], value, rtol=0, atol=2e-3 * spread,
                                           err_msg=key)


@pytest.mark.parametrize("name", ["gm3d_dino", "pointmae_teacher", "m2ae_gm3d", "probe_step",
                                  "finetune", "segmentation"])
def test_two_ranks_take_the_single_process_steps(name, ranks, single):
    _check_metrics(name, ranks, single)
    _check_bn(name, ranks, single)


def test_two_ranks_draw_the_single_process_masks(ranks, single):
    for r in ranks:
        for mask, one in zip(r["gm3d_dino"]["masks"], single["gm3d_dino"]["masks"]):
            np.testing.assert_array_equal(mask, one)


def test_global_batch_norm_on_two_shards_is_the_whole_batchs(ranks, single):
    """Outputs, running statistics and the gradients of input, weight and
    bias of ``TorchBatchNorm`` on each rank's shard, against one batch."""
    one = single["batch_norm"]
    for rank, r in enumerate(ranks):
        got = r["batch_norm"]
        rows = slice(rank * 4, (rank + 1) * 4)
        np.testing.assert_allclose(got["y"], one["y"][rows], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["x_grad"], one["x_grad"][rows], rtol=1e-4, atol=1e-6)
        for key in ("running_mean", "running_var", "weight_grad", "bias_grad"):
            np.testing.assert_allclose(got[key], one[key], rtol=1e-5, atol=1e-6, err_msg=key)


def test_gather_features_returns_the_single_process_matrix(ranks, single):
    one = single["probe_features"]
    assert one["features"].shape[0] == 10
    for r in ranks:
        np.testing.assert_allclose(r["probe_features"]["features"], one["features"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(r["probe_features"]["labels"], one["labels"])


def test_pretrain_cli_over_two_ranks_logs_the_single_process_records(ranks, single):
    """Two epochs of the pretrain CLI (a small Point-MAE, stochastic depth
    on, the SVM probe in its background thread after the last): every rank
    returns the single-process records; rank 0 alone wrote them, once each,
    and the checkpoints."""
    one = single["pretrain_cli"]
    assert len(one["records"]) == 2 and one["logged"] == one["records"]
    # one file, written by rank 0 (the wall times are each rank's own)
    assert ranks[0]["pretrain_cli"]["logged"] == ranks[0]["pretrain_cli"]["records"]
    for r in ranks:
        got = r["pretrain_cli"]
        assert len(got["logged"]) == 2 and got["ckpt"] == one["ckpt"]
        for mine, theirs in zip(got["records"], one["records"]):
            assert mine.keys() == theirs.keys()
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(mine[key], theirs[key], rtol=2e-4, err_msg=key)
            assert mine["epoch"] == theirs["epoch"] and mine["steps"] == theirs["steps"] == 2
        # the probe after the last epoch (--val_freq 2), within one of its 64
        # test clouds, as the CLI tests compare probes
        assert "val_svm_acc" not in one["records"][0]
        assert abs(got["records"][1]["val_svm_acc"]
                   - one["records"][1]["val_svm_acc"]) <= 1 / 64 + 1e-12


def test_fewshot_folds_dealt_to_ranks_give_the_single_process_accuracies(ranks, single):
    assert len(single["fewshot_folds"]["accs"]) == 2
    for r in ranks:
        assert r["fewshot_folds"]["accs"] == single["fewshot_folds"]["accs"]


# ---------------------------------------------------------------------------
# one process: a context of two ranks without a group (draws and shards read
# the rank and the world only)

@pytest.fixture
def as_rank():
    def enter(rank):
        context.set_context(context.DataParallel(group=None, host_group=None,
                                                 control_group=None, rank=rank, world=2,
                                                 device=torch.device("cpu")))
    yield enter
    context.set_context(None)


def _draw_sets(gen_seed, batch):
    """Every per-sample draw of the steps, for a batch of ``batch`` rows."""
    gen = lambda: torch.Generator().manual_seed(gen_seed)  # noqa: E731
    pt = PointTransformer(trans_dim=16, depth=1, num_heads=2, cls_dim=3, group_size=4,
                          num_group=4, encoder_dims=16)
    seg = PointMAESeg(trans_dim=16, depth=1, num_heads=2, group_size=4, num_group=4,
                      encoder_dims=16, feature_blocks=(0,), num_classes=2, num_parts=3)
    centers = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 6, 3))
                               .astype(np.float32))
    x = torch.ones(8, 5, 2)
    return {
        "step": step_draws(gen(), batch, 6),
        "random_mask": random_mask(gen(), batch, 6, 3),
        "block_mask": block_mask(gen(), shard_batch(centers), 3),
        "drop_path": drop_path(shard_batch(x), 0.5, False, gen()),
        "probe": probe_draws(gen(), batch)["dropout"],
        "finetune": finetune_draws(gen(), pt, batch, 2400, 1024),
        "seg": seg_draws(gen(), seg, batch, 32),
        "vote": vote_draws(gen(), 3, batch, 50),
    }


def _rows_of(tree, rank, dim=0):
    if isinstance(tree, dict):
        return {k: _rows_of(v, rank, dim) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rows_of(v, rank, dim) for v in tree)
    n = tree.shape[dim] // 2
    return tree.narrow(dim, rank * n, n)


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        for u, v in zip(a, b):
            _assert_equal(u, v)
    else:
        assert torch.equal(a, b)


def test_each_rank_draws_its_rows_of_the_single_process_draw(as_rank):
    whole = _draw_sets(7, 8)
    for rank in range(2):
        as_rank(rank)
        mine = _draw_sets(7, 4)
        for name, draw in whole.items():
            expected = (_rows_of(draw, rank, dim=1) if name == "vote"
                        else _rows_of(draw, rank))
            _assert_equal(mine[name], expected)
    context.set_context(None)
    # in a replica scope the rank draws for its batch alone
    as_rank(1)
    with context.replica_scope():
        _assert_equal(_draw_sets(7, 8), whole)


def test_shard_eval_batch_splits_a_whole_batch_and_keeps_a_ragged_one(as_rank):
    pts, labels = torch.arange(24.0).reshape(6, 4), torch.arange(6)
    as_rank(1)
    (rows, lab), sharded = shard_eval_batch((pts, labels))
    assert sharded and torch.equal(rows, pts[3:]) and torch.equal(lab, labels[3:])
    (rows, lab), sharded = shard_eval_batch((pts[:5], labels[:5]))
    assert not sharded and torch.equal(rows, pts[:5]) and torch.equal(lab, labels[:5])
    # a ragged batch runs whole, as one process (no gather)
    seen = []
    out = run_eval_batch(lambda p: seen.append(context.active()) or p * 2, pts[:5])
    assert seen == [None] and torch.equal(out, pts[:5] * 2)
    with pytest.raises(ValueError, match="not divisible by 2"):
        shard_batch(pts[:5])
    # the probe's blocks: array_split's, in rank order
    assert [len(rank_block(range(7)))] == [3]
    as_rank(0)
    assert len(rank_block(range(7))) == 4 and rank_block(range(7))[3] == 3


def test_num_devices_must_be_the_world_size(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert make_mesh(None, "cpu") is None and make_mesh(1, "cpu") is None
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        make_mesh(2, "cpu")
    assert context.get_context() is None


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    import yaml

    from gm3d_tpu_torch.cli import export_model

    tmp = tmp_path_factory.mktemp("fanout")
    cfg = tmp / "tiny.yaml"
    cfg.write_text(yaml.safe_dump({"npoints": 32, "model": dict(
        NAME="PointTransformer", trans_dim=16, depth=1, num_heads=2, cls_dim=3,
        group_size=4, num_group=4, encoder_dims=16, drop_path_rate=0.0)}))
    return export_model.main(["--config", str(cfg), "--device", "cpu",
                              "--out", str(tmp / "tiny.gm3dx"), "--export_batch", "2"])


def _answers(server, requests):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        out = []
        for pts in requests:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict", data=json.dumps({"points": pts}).encode(),
                headers={"Content-Type": "application/json"})
            out.append(json.loads(urllib.request.urlopen(req, timeout=60).read()))
        info = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/info",
                                                 timeout=60).read())
        return out, info
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_fan_out_server_answers_what_the_one_device_server_answers(artifact):
    from gm3d_tpu_torch.serve.server import make_server

    rng = np.random.default_rng(3)
    requests = [rng.standard_normal((b, 32, 3)).astype(np.float32).tolist() for b in (1, 2, 5)]
    one, _ = _answers(make_server(artifact, device="cpu", dynamic_batching=False), requests)
    fan, info = _answers(make_server(artifact, device="cpu", num_devices=2,
                                     dynamic_batching=False), requests)
    assert info["serving_devices"] == 2
    for a, b in zip(one, fan):
        assert a["label"] == b["label"]
        np.testing.assert_allclose(np.asarray(b["outputs"]), np.asarray(a["outputs"]),
                                   rtol=1e-6, atol=1e-6)
