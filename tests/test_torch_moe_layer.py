"""``MoELayer`` of the PyTorch port against the JAX package's, on the CPU.

The reference's ``build_moe`` (``tests/test_moe.py``: 4 experts of two
``Linear``s around a relu, a bias-free gate, top-2) is built from its
seed and its weights are carried across as numpy. Single shard: the
port's output and every gradient (experts, gate, input) equal the
reference's within ``ATOL`` (fp32 sums in another order) at capacity
factor 8.0 (nothing drops) and 1.0 (choices drop), the output equals the
manual top-k reference, and a [B, S, D] input keeps its shape.

Expert parallel: one launch of four gloo rank processes (this file run as
a script, each process and the group with its own timeout), each passing
its block of the 32 tokens through an ``MoELayer`` over the four-rank
group and computing its experts' gradients of the sum of every rank's
squared outputs. The concatenated outputs equal the reference's
expert-parallel ``MoELayer`` on a (4, 2) ``ep`` x ``dp`` mesh of host
devices within ``ATOL``, at factor 8.0 and at 1.0 (where a block's own
capacity drops choices that a single shard would keep); each rank's
expert gradients equal a one-process computation of the same block-wise
function. The ranks also check ``alltoall`` and ``alltoall_single``
(equal chunks and given split sizes) and their ``collective_stats``.
"""

import json
import os
import socket
import subprocess
import sys
import traceback

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
D, E, T, HID = 16, 4, 32, 32
N_RANKS = 4
FACTORS = (8.0, 1.0)
WORKER_TIMEOUT_S = 240
GROUP_TIMEOUT_S = 60


def _port_moe(state, capacity_factor, group=None):
    """The port's MoELayer over experts and a gate from ``state`` (the
    reference's numpy weights: ``expert_<i>.*`` and ``gate.weight``)."""
    import torch

    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.models import load_paddle_tpu_state_dict
    from paddle_tpu_torch.nn import Linear

    class Expert(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = Linear(D, HID, device="cpu")
            self.fc2 = Linear(HID, D, device="cpu")

        def forward(self, x):
            return self.fc2(torch.relu(self.fc1(x)))

    experts = []
    for i in range(E):
        e = Expert()
        load_paddle_tpu_state_dict(e, {
            k[len(f"expert_{i}."):]: v for k, v in state.items()
            if k.startswith(f"expert_{i}.")})
        experts.append(e)
    gate = Linear(D, E, bias_attr=False, device="cpu")
    load_paddle_tpu_state_dict(gate, {"weight": state["gate.weight"]})
    return MoELayer(D, experts, gate=gate, moe_group=group, top_k=2,
                    capacity_factor=capacity_factor)


def _expert_grads(moe, which):
    """{"<i>.<param>": grad} of experts ``which``."""
    return {f"{i}.{n}": p.grad.numpy().copy()
            for i in which for n, p in moe.experts[i].named_parameters()}


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def _reference(capacity_factor, group=None):
    from test_moe import build_moe

    moe, experts, gate = build_moe(group=group,
                                   capacity_factor=capacity_factor)
    return moe, experts, gate


def _reference_state(experts, gate):
    state = {"gate.weight": np.asarray(gate.weight.numpy())}
    for i, e in enumerate(experts):
        for k, v in e.state_dict().items():
            state[f"expert_{i}.{k}"] = np.asarray(v.numpy())
    return state


def _x(seed=3, shape=(T, D)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    _, experts, gate = _reference(8.0)
    return _reference_state(experts, gate)


# ---------------------------------------------------------------------------
# single shard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor", FACTORS)
def test_single_shard_output_and_grads_match_reference(factor):
    import paddle_tpu as paddle
    import torch

    moe, experts, gate = _reference(factor)
    x = _x()
    xr = paddle.to_tensor(x, stop_gradient=False)
    yr = moe(xr)
    (yr * yr).sum().backward()
    tm = _port_moe(_reference_state(experts, gate), factor)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = tm(xt)
    (yt * yt).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), yr.numpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(float(tm.l_aux.detach()),
                               float(moe.l_aux.numpy()),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(xr.grad.numpy()),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(tm.gate.weight.grad.numpy(),
                               np.asarray(gate.weight.grad.numpy()),
                               rtol=0, atol=ATOL)
    for i, e in enumerate(experts):
        for name, p in tm.experts[i].named_parameters():
            want = np.asarray(
                dict(e.named_parameters())[name].grad.numpy())
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                       atol=ATOL, err_msg=f"{i}.{name}")
            assert np.abs(want).sum() > 0


def test_single_shard_matches_manual_topk(weights):
    import torch

    tm = _port_moe(weights, 8.0)
    x = _x(seed=4)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        logits = tm.gate(torch.from_numpy(x)).numpy()
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.zeros_like(x)
    for t in range(T):
        idx = np.argsort(-p[t], kind="stable")[:2]
        w = p[t, idx] / p[t, idx].sum()
        for wk, e in zip(w, idx):
            with torch.no_grad():
                want[t] += wk * tm.experts[e](torch.from_numpy(
                    x[t:t + 1])).numpy()[0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=ATOL)


def test_batch_seq_input_keeps_its_shape(weights):
    import torch

    tm = _port_moe(weights, 8.0)
    x = torch.from_numpy(_x(seed=5, shape=(2, 8, D)))
    y = tm(x)
    assert tuple(y.shape) == (2, 8, D)
    flat = tm(x.reshape(16, D))
    torch.testing.assert_close(y.reshape(16, D), flat, rtol=0, atol=0)


def test_structurally_different_experts_refused(weights):
    import torch

    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.nn import Linear

    experts = [Linear(D, D, device="cpu"),
               Linear(D, D, bias_attr=False, device="cpu")]
    with pytest.raises(ValueError, match="structurally identical"):
        MoELayer(D, experts, gate=Linear(D, 2, device="cpu"))
    with pytest.raises(ValueError, match="gate"):
        MoELayer(D, experts[:1])(torch.zeros(2, D))


def test_world_of_one_collectives_are_the_identity():
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import communication as comm

    x = torch.arange(8.0).reshape(4, 2)
    out = []
    dist.alltoall(out, [x, x + 1])
    assert len(out) == 2 and out[0] is x
    assert dist.all_to_all is dist.alltoall
    dst = torch.zeros_like(x)
    dist.alltoall_single(dst, x)
    torch.testing.assert_close(dst, x, rtol=0, atol=0)
    assert comm.alltoall_single_grad(x) is not x
    torch.testing.assert_close(comm.alltoall_single_grad(x), x, rtol=0,
                               atol=0)
    assert comm.all_reduce_mean_grad(x) is x


# ---------------------------------------------------------------------------
# expert parallel: the rank process
# ---------------------------------------------------------------------------

def _blockwise_grads(state, x, factor, n):
    """One process computing the expert-parallel form's function: each of
    the n token blocks gated with its own capacity, the experts applied to
    every block's slots, combined per block; the experts' gradients of the
    sum of the blocks' squared outputs."""
    import torch

    from paddle_tpu_torch.incubate.distributed.models.moe import (
        combine_from_experts, dispatch_to_experts, moe_capacity,
        top_k_capacity_gating)

    moe = _port_moe(state, factor)
    loss = 0.0
    for xb in torch.from_numpy(x).chunk(n):
        probs = torch.softmax(moe.gate(xb).float(), dim=-1)
        C = moe_capacity(xb.shape[0], E, 2, factor)
        ei, si, keep, w, _ = top_k_capacity_gating(probs, 2, C)
        buf = dispatch_to_experts(xb, ei, si, keep, E, C)
        out = torch.stack([moe.experts[e](buf[e]) for e in range(E)])
        y = combine_from_experts(out, ei, si, keep, w)
        loss = loss + (y * y).sum()
    loss.backward()
    return _expert_grads(moe, range(E))


def _rank_main(rank, port, work):
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import communication as comm

    torch.set_num_threads(1)
    dist.init_parallel_env(rank=rank, world_size=N_RANKS,
                           init_method=f"tcp://127.0.0.1:{port}",
                           device="cpu", timeout_s=GROUP_TIMEOUT_S)
    group = dist.new_group(list(range(N_RANKS)))
    state = dict(np.load(os.path.join(work, "weights.npz")))
    x = np.load(os.path.join(work, "x.npy"))
    out = {"collectives": {}}
    # the collectives themselves
    comm.reset_collective_stats()
    sent = [torch.full((2, 3), 10.0 * rank + j) for j in range(N_RANKS)]
    got = []
    dist.all_to_all(got, sent, group=group)
    out["collectives"]["alltoall"] = [t.tolist() for t in got]
    src = torch.arange(N_RANKS * 2, dtype=torch.float32) + 100 * rank
    dst = torch.empty_like(src)
    dist.alltoall_single(dst, src, group=group)
    out["collectives"]["single"] = dst.tolist()
    # rank r sends r + 1 rows to every rank; receives j + 1 from rank j
    src = torch.full((N_RANKS * (rank + 1),), float(rank))
    dst = torch.empty(sum(j + 1 for j in range(N_RANKS)))
    dist.alltoall_single(dst, src, in_split_sizes=[rank + 1] * N_RANKS,
                         out_split_sizes=[j + 1 for j in range(N_RANKS)],
                         group=group)
    out["collectives"]["split"] = dst.tolist()
    out["collectives"]["stats"] = {
        k: v["calls"] for k, v in comm.collective_stats().items()}
    # the expert-parallel layer on this rank's block
    block = T // N_RANKS
    for factor in FACTORS:
        moe = _port_moe(state, factor, group=group)
        xb = torch.from_numpy(x[rank * block:(rank + 1) * block])
        y = moe(xb)
        (y * y).sum().backward()
        local = E // N_RANKS
        mine = range(rank * local, (rank + 1) * local)
        out[str(factor)] = {
            "y": y.detach().tolist(), "l_aux": float(moe.l_aux),
            "grads": {k: v.tolist()
                      for k, v in _expert_grads(moe, mine).items()},
            "others_untouched": all(
                p.grad is None for i in range(E) if i not in mine
                for p in moe.experts[i].parameters()),
            "gate_grad": moe.gate.weight.grad.tolist()}
    return out


# ---------------------------------------------------------------------------
# the launch, once for the module
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def ep_run(tmp_path_factory, weights):
    """Every rank's results and the inputs they were given."""
    work = str(tmp_path_factory.mktemp("moe_ep"))
    x = _x(seed=7)
    np.savez(os.path.join(work, "weights.npz"), **weights)
    np.save(os.path.join(work, "x.npy"), x)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               TORCH_CPP_LOG_LEVEL="ERROR")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(port),
         work], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(N_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = []
    for r in range(N_RANKS):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return {"ranks": ranks, "x": x, "state": weights}


@pytest.mark.parametrize("factor", FACTORS)
def test_expert_parallel_equals_reference_ep(ep_run, factor):
    import jax

    import paddle_tpu as paddle
    from paddle_tpu.distributed.collective import Group

    mesh = jax.make_mesh((4, 2), ("ep", "dp"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    grp = Group(list(range(4)), axis_name="ep", mesh=mesh)
    moe, _, _ = _reference(factor, group=grp)
    want = np.asarray(moe(paddle.to_tensor(ep_run["x"])).numpy())
    got = np.concatenate([np.asarray(r[str(factor)]["y"])
                          for r in ep_run["ranks"]])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for r in ep_run["ranks"]:
        np.testing.assert_allclose(r[str(factor)]["l_aux"],
                                   float(moe.l_aux.numpy()), rtol=0,
                                   atol=ATOL)


def test_per_block_capacity_drops_at_factor_one(ep_run):
    """At factor 1.0 a block's own capacity (moe_capacity(8, 4, 2, 1.0) =
    4) drops choices a single shard (capacity 16) keeps: the outputs
    differ from the single-shard layer's, as the reference's do."""
    import torch

    single = _port_moe(ep_run["state"], 1.0)
    with torch.no_grad():
        one = single(torch.from_numpy(ep_run["x"])).numpy()
    ep = np.concatenate([np.asarray(r["1.0"]["y"])
                         for r in ep_run["ranks"]])
    assert np.abs(ep - one).max() > 1e-3


@pytest.mark.parametrize("factor", FACTORS)
def test_expert_parallel_grads_reach_every_rank(ep_run, factor):
    want = _blockwise_grads(ep_run["state"], ep_run["x"], factor, N_RANKS)
    for rank, r in enumerate(ep_run["ranks"]):
        res = r[str(factor)]
        assert res["others_untouched"]
        assert len(res["grads"]) == 4 * (E // N_RANKS)
        for name, g in res["grads"].items():
            assert int(name.split(".")[0]) // (E // N_RANKS) == rank
            np.testing.assert_allclose(np.asarray(g), want[name], rtol=0,
                                       atol=ATOL, err_msg=name)
            assert np.abs(want[name]).sum() > 0, name


def test_alltoall_across_four_ranks(ep_run):
    for rank, r in enumerate(ep_run["ranks"]):
        c = r["collectives"]
        assert c["alltoall"] == [np.full((2, 3), 10.0 * j + rank).tolist()
                                 for j in range(N_RANKS)]
        assert c["single"] == [100.0 * j + 2 * rank + i
                               for j in range(N_RANKS) for i in range(2)]
        assert c["split"] == [float(j) for j in range(N_RANKS)
                              for _ in range(j + 1)]
        assert c["stats"] == {"alltoall": 1, "alltoall_single": 2}


if __name__ == "__main__":
    rank, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    try:
        result = _rank_main(rank, port, work)
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    sys.exit(0)
