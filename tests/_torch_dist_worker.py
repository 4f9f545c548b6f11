"""One rank of the multi-rank checks of tests/test_torch_dist_train.py: 4
gloo ranks on the CPU, a (2, 2) ("data", "model") mesh. Imports no JAX:
the test process computes the JAX references and hands them over as numpy
arrays in ``inputs.pt``; each rank writes its results to ``rank<r>.pt``
(or its traceback to ``rank<r>.err``).

Run by `run_ranks`, which spawns the ranks on a free local port, bounds
each collective and the whole run in time, and fails on the first rank
that fails instead of waiting for the others."""
from __future__ import annotations

import datetime
import multiprocessing as mp
import pathlib
import socket
import time
import traceback

import numpy as np
import torch

WORLD = 4
COLLECTIVE_TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(workdir: pathlib.Path, timeout_s: float = 240.0) -> list[dict]:
    """Spawn WORLD ranks of `main`; → each rank's results. Raises with the
    failing rank's traceback if one fails, or if the run outlasts
    `timeout_s`; no rank outlives the call."""
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=main, args=(r, port, str(workdir)), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    errs = sorted(workdir.glob("rank*.err"))
    if errs:
        raise RuntimeError("\n".join(e.read_text() for e in errs))
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"ranks ended with exit codes {codes} (timeout {timeout_s} s)")
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def main(rank: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    work = pathlib.Path(workdir)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        inp = torch.load(work / "inputs.pt", weights_only=False)
        res = {}
        for check in (trainer_check, placement_faults_check, flash_check, compression_check,
                      moe_check, psum_check, restore_check, seq_cache_check):
            res.update(check(rank, inp, work))
        torch.save(res, work / f"rank{rank}.pt")
    except BaseException:
        (work / f"rank{rank}.err").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
def _mesh(n_data: int = 2, n_model: int = 2):
    from repro_torch.launch.mesh import make_small_mesh

    return make_small_mesh(n_data, n_model, device_type="cpu")


def _full(t):
    from repro_torch.dist.sharding import full_tensor

    return full_tensor(t).detach().clone()


def _trainer(inp, work, name, mesh, **tc):
    from repro_torch import bridge
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer

    cfg = inp["cfg"]
    model = bridge.lm_from_jax(inp["params"], cfg, device="cpu")
    tc = TrainConfig(total_steps=1, log_every=1, checkpoint_dir=str(work / name), **tc)
    return Trainer(cfg, AdamWConfig(**inp["opt"]), tc, DataConfig(**inp["data"]), device="cpu",
                   model=model, mesh=mesh)


def qw_placements(trainer) -> dict:
    """Each "qw" parameter's placements and local shape."""
    return {n: (tuple(p.placements), tuple(p.to_local().shape))
            for n, p in trainer.state["params"].items() if n.endswith(".qw")}


def qw_sharded(trainer) -> bool:
    """Every qw leaf is a DTensor sharded on each mesh dim (no weight is
    silently replicated), with its rules' placements."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist.sharding import param_spec, to_placements

    for n, p in trainer.state["params"].items():
        if not n.endswith(".qw"):
            continue
        want = to_placements(param_spec(n.split("."), p.shape, trainer.mesh, trainer.cfg),
                             trainer.mesh)
        if not isinstance(p, DTensor) or tuple(p.placements) != want:
            return False
        if any(pl == Replicate() for pl in p.placements):
            return False
    return True


def residual_placements(model, cfg, mesh, tokens) -> tuple:
    """The placements of the residual stream entering the layers in a
    sharded forward (read through `decoder.layers_apply`)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist.sharding import batch_shardings, distribute_tree, use_sharding_ctx
    from repro_torch.models import decoder

    seen = []
    real = decoder.layers_apply

    def spy(layers, specs, x, **kw):
        seen.append(tuple(x.placements))
        return real(layers, specs, x, **kw)

    batch = distribute_tree({"tokens": tokens}, batch_shardings({"tokens": tokens}, mesh, cfg))
    decoder.layers_apply = spy
    try:
        with torch.no_grad(), use_sharding_ctx(mesh, cfg), implicit_replication():
            decoder.lm_hidden(model, batch["tokens"], cfg, mode="train")
    finally:
        decoder.layers_apply = real
    return seen[0]


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------
def trainer_check(rank, inp, work) -> dict:
    """3 sharded QAT steps from the bridged JAX weights: losses, the params
    after step 1, and the qw placements."""
    from repro_torch import bridge

    mesh = _mesh()
    tr = _trainer(inp, work, "shard", mesh)
    tr.run()
    params1 = bridge.to_jax_tree({n: _full(p) for n, p in tr.model.named_parameters()},
                                 inp["cfg"])
    tr.tc.total_steps = 3
    log = tr.run()
    out = {"losses": [r["loss"] for r in log], "params1": params1,
           "qw_placements": qw_placements(tr), "qw_sharded": qw_sharded(tr),
           "residual": residual_placements(tr.model, inp["cfg"], mesh,
                                           torch.from_numpy(inp["tokens"]))}
    # the trained state, as run() saved it (blocking, at step 3) for the
    # elastic restore
    out["saved_full"] = {n: _full(p) for n, p in tr.state["params"].items()}
    out["saved_opt_m"] = {n: _full(m.q if hasattr(m, "q") else m)
                          for n, m in tr.state["opt"]["m"].items()}
    return out


def placement_faults_check(rank, inp, work) -> dict:
    """Two planted faults, one call each: a rule that replicates qw, and
    shard_act dropped at the "btd" site. The checks above must read them
    as faults."""
    from repro_torch.dist import sharding
    from repro_torch.models import decoder

    mesh = _mesh()
    real_rule = sharding.param_spec

    def replicate_qw(names, shape, mesh_, cfg):
        spec = real_rule(names, shape, mesh_, cfg)
        return (None,) * len(spec) if list(names)[-1] == "qw" else spec

    sharding.param_spec = replicate_qw
    try:
        tr = _trainer(inp, work, "fault_rule", mesh)
    finally:
        sharding.param_spec = real_rule
    out = {"fault_rule_qw_sharded": qw_sharded(tr)}

    real_act = decoder.shard_act
    decoder.shard_act = lambda x, name: x if name == "btd" else real_act(x, name)
    try:
        tr = _trainer(inp, work, "fault_btd", mesh)
        try:
            out["fault_btd_residual"] = residual_placements(tr.model, inp["cfg"], mesh,
                                                            torch.from_numpy(inp["tokens"]))
        except Exception as e:  # noqa: BLE001 — a crash is the fault showing
            out["fault_btd_residual"] = f"{type(e).__name__}: {e}"
    finally:
        decoder.shard_act = real_act
    return out


def flash_check(rank, inp, work) -> dict:
    """lm_loss and its gradients with attn_impl="flash" under the mesh (the
    kernel's wrapper on local (batch, heads) blocks through local_map)
    against the port's unsharded loss."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist.sharding import (
        batch_shardings,
        distribute,
        distribute_tree,
        param_shardings,
        use_sharding_ctx,
    )
    from repro_torch.models import lm_loss

    from repro_torch.models import init_lm

    cfg = inp["heads_cfg"].with_(attn_impl="flash")
    mesh = _mesh()
    tok, lab = torch.from_numpy(inp["tokens"]), torch.from_numpy(inp["labels"])
    ref = init_lm(cfg, torch.Generator().manual_seed(5)).requires_grad_(True)
    rl, _ = lm_loss(ref, tok, lab, cfg)
    rl.backward()
    model = init_lm(cfg, torch.Generator().manual_seed(5))
    params = dict(model.named_parameters())
    shard = param_shardings(params, mesh, cfg)
    for n, p in params.items():
        owner, leaf = n.rsplit(".", 1)
        setattr(model.get_submodule(owner), leaf,
                torch.nn.Parameter(distribute(p.detach(), shard[n])))
    batch = {"tokens": tok, "labels": lab}
    batch = distribute_tree(batch, batch_shardings(batch, mesh, cfg))
    with use_sharding_ctx(mesh, cfg), implicit_replication():
        loss, _ = lm_loss(model, batch["tokens"], batch["labels"], cfg)
        loss.backward()
    gerr = max(float((_full(p.grad) - q.grad).abs().max() / q.grad.abs().max().clamp_min(1e-30))
               for p, q in zip(model.parameters(), ref.parameters()))
    heads = {n: tuple(p.placements) for n, p in model.named_parameters() if n.endswith("wq.qw")}
    return {"flash_loss": (_full(loss).item(), rl.item()), "flash_grad_rel": gerr,
            "flash_wq_placements": heads}


def compression_check(rank, inp, work) -> dict:
    """2 sharded steps with gradient compression against the port's
    unsharded trainer with it."""
    out = {}
    for name, mesh in (("compress_mesh", _mesh()), ("compress_plain", None)):
        tr = _trainer(inp, work, name, mesh, grad_compression=True)
        tr.tc.total_steps = 2
        out[name] = [r["loss"] for r in tr.run()]
    return out


def moe_check(rank, inp, work) -> dict:
    """One forward and backward of a MoE FFN with block-local dispatch under
    the mesh (dispatch_blocks = 2 data shards) against the unsharded
    moe_apply(n_blocks=2)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist.sharding import (
        act_spec,
        dispatch_blocks,
        distribute,
        param_shardings,
        to_placements,
        use_sharding_ctx,
    )
    from repro_torch.models.moe import moe_apply, moe_init

    cfg = inp["moe_cfg"]
    mesh = _mesh()
    x_np = np.random.default_rng(3).standard_normal((4, 8, cfg.d_model)).astype(np.float32)

    def layer():
        return moe_init(cfg, generator=torch.Generator().manual_seed(7),
                        device=torch.device("cpu")).requires_grad_(True)

    ref = layer()
    x_ref = torch.from_numpy(x_np).requires_grad_(True)
    out_ref, aux_ref = moe_apply(ref, x_ref, cfg, "train", n_blocks=2)
    ((out_ref ** 2).sum() + aux_ref).backward()

    p = layer()
    params = {f"ffn.{n}": t for n, t in p.named_parameters()}
    shard = param_shardings(params, mesh, cfg)
    for n, t in params.items():
        owner, leaf = n[len("ffn."):].rsplit(".", 1)
        setattr(p.get_submodule(owner), leaf, torch.nn.Parameter(distribute(t.detach(), shard[n])))
    placements = {n: tuple(t.placements) for n, t in p.named_parameters()}
    from torch.distributed.tensor import distribute_tensor

    x = distribute_tensor(torch.from_numpy(x_np),
                          mesh, to_placements(act_spec("btd", x_np.shape, mesh, cfg), mesh))
    x = x.detach().requires_grad_(True)
    with use_sharding_ctx(mesh, cfg), implicit_replication():
        nb = dispatch_blocks(x.shape[0] * x.shape[1])
        out, aux = moe_apply(p, x, cfg, "train")
        ((out ** 2).sum() + aux).backward()
    grads = {n: (_full(t.grad), q.grad) for (n, t), q in zip(p.named_parameters(), ref.parameters())}
    return {"moe_nb": nb, "moe_out": (_full(out), out_ref.detach()),
            "moe_aux": (_full(aux).item(), aux_ref.item()),
            "moe_xgrad": (_full(x.grad), x_ref.grad), "moe_grads": grads,
            "moe_placements": placements}


def psum_check(rank, inp, work) -> dict:
    """compressed_psum over the world and over the mesh's "data" dim."""
    from repro_torch.dist.compression import compressed_psum

    mesh = _mesh()
    x = torch.from_numpy(psum_input(rank))
    return {"psum_world": compressed_psum(x),
            "psum_data": compressed_psum(x, mesh.get_group("data")),
            "data_coord": mesh.get_coordinate()}


def psum_input(rank: int) -> np.ndarray:
    return (np.random.default_rng(100 + rank).standard_normal((6, 40)) * (rank + 1)
            ).astype(np.float32)


def restore_check(rank, inp, work) -> dict:
    """The (2, 2) trainer's checkpoint restored onto a (4, 1) mesh and onto
    no mesh: the full tensors of every parameter and first moment."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.dist.sharding import opt_shardings, param_shardings

    ck = Checkpointer(str(work / "shard"))
    tr = _trainer(inp, work, "template", None)     # an unsharded state as the template
    template = {"params": dict(tr.state["params"]), "opt": tr.state["opt"]}
    mesh41 = _mesh(4, 1)
    cfg = inp["cfg"]
    shard = {"params": param_shardings(template["params"], mesh41, cfg),
             "opt": opt_shardings(template["opt"], mesh41, cfg)}
    on41, _ = ck.restore(template, shardings=shard)
    plain, _ = ck.restore(template)
    pl41 = {n: tuple(p.placements) for n, p in on41["params"].items()}
    return {
        "restore41": {n: _full(p) for n, p in on41["params"].items()},
        "restore41_m": {n: _full(m.q if hasattr(m, "q") else m)
                        for n, m in on41["opt"]["m"].items()},
        "restore41_placements": pl41,
        "restore_plain": {n: p.detach().clone() for n, p in plain["params"].items()},
    }


def seq_cache_check(rank, inp, work) -> dict:
    """B = 1 prefill writes of S = 12 tokens into caches of L = 32 slots
    sharded over their sequence (blocks of 8 over a (4, 1) mesh's "data",
    as `cache_spec` places a B = 1 cache), by `write_rows`, each against
    the same write into the unsharded cache: from slot 0 (a real write
    lands on rank 0's local slot 0, other ranks' entries after it), around
    the ring's end, and with MLA's dropped slots (`keep`); a (B, L, H, D)
    k cache and a (B, L) slot-position cache."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist.sharding import cache_spec, to_placements, write_rows

    mesh = _mesh(4, 1)
    big, s = 32, 12
    gen = torch.Generator().manual_seed(11)
    out = {}
    for case, start, drop in (("from0", 0, False), ("ring", 26, False), ("drop", 26, True)):
        pos = start + torch.arange(s)[None, :]
        slots, keep = (pos % big, pos < big) if drop else (pos % big, None)
        for name, shape in (("k", (1, big, 2, 4)), ("slot_pos", (1, big))):
            spec = cache_spec(["layers", "0", "mixer", name], shape, mesh, inp["cfg"])
            placements = to_placements(spec, mesh)
            assert tuple(placements) == (Shard(1), Replicate()), (name, placements)
            if name == "k":
                old = torch.randn(shape, generator=gen)
                vals = torch.randn((1, s, *shape[2:]), generator=gen)
            else:
                old = torch.randint(-5, 0, shape, generator=gen, dtype=torch.int32)
                vals = pos.to(torch.int32)
            want = old.clone()
            write_rows(want, slots, vals, keep)
            leaf = distribute_tensor(old.clone(), mesh, placements)
            rep = [Replicate(), Replicate()]
            write_rows(leaf, distribute_tensor(slots, mesh, rep),
                       distribute_tensor(vals, mesh, rep),
                       None if keep is None else distribute_tensor(keep, mesh, rep))
            out[f"{case}.{name}"] = (_full(leaf), want)
    return {"seq_cache": out}

