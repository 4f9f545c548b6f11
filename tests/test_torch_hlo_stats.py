"""The port's step statistics (`repro_torch.roofline.hlo_stats`, the
traceable kernel operators of `repro_torch.kernels._library`, the fake mesh
of `launch.mesh.fake_mesh` and the dry run's trace) against the JAX
package on the CPU:

  * `dot_flops` of a trace equal `repro.roofline.hlo_stats.parse_hlo_stats`
    of the XLA-compiled JAX function, exactly, on the four workloads of
    tests/test_hlo_stats.py (a trace unrolls the loops XLA keeps as whiles);
  * `collective_bytes` gives, kind by kind, the bytes and counts that
    tests/test_roofline.py expects of its HLO, for the same result shapes,
    from programs on a fake mesh of world 8 (DTensor redistributions, and
    the functional collectives DTensor calls for all-to-all and a
    permutation);
  * each rule of the eager traffic model in closed form;
  * each kernel operator: its fake implementation gives the CPU
    implementation's shape, dtype and strides, the CPU implementation is
    the plain version bit for bit, the wrappers route fake tensors to it
    (one operator a launch, no counter moved), and a plan crosses its
    schema and back;
  * small-config smollm decode and training traces: the launches equal the
    count `launch_tiles` (flash: one a layer, twice under remat) predicts
    and `dot_flops` equals `FlopCounterMode` on the same fake inputs;
  * the dry run's trace on small meshes with every field filled; its
    greedy pricing of DTensor's strategies gives the op stream DTensor's
    own prices give, DTensor's global-shape propagation stays out of the
    record, and a missing patch target raises.

A fixture destroys any process group a test leaves, so nothing leaks into
later files in the same worker. The fake tensors sit on the cpu device: a
CPU-only torch build's autograd aborts the process on a fake cuda tensor
(the card's build traces fake cuda tensors, `chip_smoke.py` phase 18)."""
import lzma

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.roofline.analysis import collective_bytes as jax_collective_bytes  # noqa: E402
from repro.roofline.hlo_stats import parse_hlo_stats  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.quantize import act_token_scale  # noqa: E402
from repro_torch.kernels import _library, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ternary_decode_gemm as tdg  # noqa: E402
from repro_torch.kernels import vlut_lookup_gemm as vlg  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import ShapeMesh, fake_mesh, mesh_axes, small_shape  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step,
    make_prefill_step,
    make_train_step,
    meta_model,
)
from repro_torch.models import init_cache, init_lm, pack_params, stacked_shapes  # noqa: E402
from repro_torch.models.common import PackedLinear  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.roofline.analysis import (  # noqa: E402
    HBM_BW,
    LINK_BW,
    PEAK_FLOPS,
    collective_bytes,
    mpgemm_cost,
)
from repro_torch.roofline.hlo_stats import (  # noqa: E402
    HloStats,
    Trace,
    fake_module,
    op_traffic,
    step_stats,
    trace_step,
)


@pytest.fixture(autouse=True)
def no_process_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
        pytest.fail("a test left a process group behind")


def fake(*shapes, dtype=torch.float32, mode=None):
    mode = mode or FakeTensorMode()
    with mode:
        return [torch.empty(s, dtype=dtype) for s in shapes]


def jax_dot_flops(fn, *args) -> float:
    return parse_hlo_stats(jax.jit(fn).lower(*args).compile().as_text()).dot_flops


def port_dot_flops(fn, *args) -> float:
    trace, _ = trace_step(fn, *args)
    return step_stats(trace).dot_flops


# --------------------------------------------------------------------------
# dot FLOPs: the four workloads of tests/test_hlo_stats.py
# --------------------------------------------------------------------------
def test_dot_flops_single_matmul():
    want = jax_dot_flops(lambda a, b: a @ b, jnp.ones((128, 64)), jnp.ones((64, 32)))
    got = port_dot_flops(lambda a, b: a @ b, *fake((128, 64), (64, 32)))
    assert got == want == 2 * 128 * 64 * 32


def test_dot_flops_loop_of_seven_against_scan():
    w, x = jnp.ones((64, 64)), jnp.ones((128, 64))
    want = jax_dot_flops(
        lambda x: jax.lax.scan(lambda c, _: (c @ w, None), x, None, length=7)[0], x)

    def loop(x, w):
        for _ in range(7):
            x = x @ w
        return x

    got = port_dot_flops(loop, *fake((128, 64), (64, 64)))
    assert got == want == 7 * 2 * 128 * 64 * 64


def test_dot_flops_nested_loops():
    w, x = jnp.ones((32, 32)), jnp.ones((16, 32))

    def inner(c):
        return jax.lax.scan(lambda ci, _: (ci @ w, None), c, None, length=3)[0]

    want = jax_dot_flops(
        lambda x: jax.lax.scan(lambda c, _: (inner(c) @ w, None), x, None, length=5)[0], x)

    def loops(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
            x = x @ w
        return x

    trace, _ = trace_step(loops, *fake((16, 32), (32, 32)))
    st = step_stats(trace)
    assert st.dot_flops == want == 5 * (3 + 1) * 2 * 16 * 32 * 32
    assert st.n_whiles is None and st.unknown_trip_whiles is None   # unrolled: no whiles


def test_dot_flops_batched_einsum():
    want = jax_dot_flops(lambda a, b: jnp.einsum("bik,bkj->bij", a, b),
                         jnp.ones((4, 16, 8)), jnp.ones((4, 8, 32)))
    got = port_dot_flops(lambda a, b: torch.einsum("bik,bkj->bij", a, b),
                         *fake((4, 16, 8), (4, 8, 32)))
    assert got == want == 2 * 4 * 16 * 8 * 32


def test_addmm_counts_its_product_only():
    a, b, bias = fake((8, 16), (16, 4), (4,))
    assert port_dot_flops(torch.addmm, bias, a, b) == 2 * 8 * 16 * 4


@pytest.mark.parametrize("fn,bias,want", [
    (torch.baddbmm, (3, 8, 4), 2 * 3 * 8 * 4 * 16),   # a product a batch
    (torch.addbmm, (8, 4), 2 * 8 * 4 * (3 * 16)),     # summed over the batch too
])
def test_batched_adds_count_their_products(fn, bias, want):
    b1, b2, c = fake((3, 8, 16), (3, 16, 4), bias)
    assert port_dot_flops(fn, c, b1, b2) == want


# --------------------------------------------------------------------------
# collectives: tests/test_roofline.py's figures from programs on a fake mesh
# --------------------------------------------------------------------------
JAX_HLO = """
HloModule jit_step
ENTRY %main {
  %p0 = f32[8,128]{1,0} parameter(0)
  %ar = f32[8,128]{1,0} all-reduce(%p0), replica_groups={{0,1}}
  %ag.1 = bf16[16,256]{1,0} all-gather(%p0), dimensions={0}
  %rs = f32[4,128]{1,0} reduce-scatter(%ar), dimensions={0}
  %a2a = (s8[2,64]{1,0}, s8[2,64]{1,0}) all-to-all(%p0, %p0)
  %cp = u8[32]{0} collective-permute(%p0), source_target_pairs={{0,1}}
  %add = f32[8,128]{1,0} add(%p0, %ar)
}
"""


def test_collective_bytes_match_the_jax_figures():
    """One collective of each kind, each with the JAX test's result shape:
    all-reduce f32[8,128] (Partial → Replicate), all-gather bf16[16,256]
    (Shard → Replicate), reduce-scatter f32[4,128] (Partial → Shard), one
    all-to-all with a s8 result of 2·(2·64) bytes (`all_to_all_single`,
    which DTensor calls for Shard → Shard on a card's mesh; on the cpu it
    gathers instead) and a collective-permute u8[32] (`permute_tensor`:
    each rank's block whole to the next)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    with fake_mesh(ShapeMesh(x=8), "cpu") as mesh:
        mode = FakeTensorMode()
        with mode:
            part = DTensor.from_local(torch.empty(8, 128), mesh, [Partial()], run_check=False)
            shard = DTensor.from_local(torch.empty(2, 256, dtype=torch.bfloat16), mesh,
                                       [Shard(0)], run_check=False)
            part2 = DTensor.from_local(torch.empty(32, 128), mesh, [Partial()], run_check=False)
            codes = torch.empty(8, 32, dtype=torch.int8)       # a row to each rank
            block = torch.empty(32, dtype=torch.uint8)

        def program(part, shard, part2, codes, block):
            group = mesh.get_group()
            return (part.redistribute(mesh, [Replicate()]),
                    shard.redistribute(mesh, [Replicate()]),
                    part2.redistribute(mesh, [Shard(0)]),
                    funcol.all_to_all_single(codes, [1] * 8, [1] * 8, group),
                    funcol.permute_tensor(block, [(r + 1) % 8 for r in range(8)], group))

        trace, _ = trace_step(program, part, shard, part2, codes, block)
    got, want = collective_bytes(trace.ops), jax_collective_bytes(JAX_HLO)
    assert got == {k: {"bytes": v["bytes"], "count": v["count"]} for k, v in want.items()}
    assert got["all-reduce"] == {"bytes": 8 * 128 * 4, "count": 1}
    assert got["all-to-all"]["bytes"] == 2 * (2 * 64)
    assert got["collective-permute"]["bytes"] == 32
    st = step_stats(trace)
    assert st.collective_bytes == sum(v["bytes"] for v in want.values())
    # waits are free, and collectives move no HBM bytes in the traffic model
    assert all(op_traffic(op) == 0 for op in trace.ops if "c10d" in op["op"])


def test_non_collectives_ignored():
    trace, _ = trace_step(lambda a, b: a + b, *fake((8, 8), (8, 8)))
    assert sum(v["bytes"] for v in collective_bytes(trace.ops).values()) == 0


def test_fake_mesh_lifetime():
    """The group lives exactly as long as the context, at the mesh's world
    size; a sweep enters one context a cell, world sizes changing."""
    for shape in (small_shape(), small_shape(multi_pod=True), ShapeMesh(data=16, model=16)):
        with fake_mesh(shape, "cpu") as mesh:
            assert dist.get_world_size() == shape.size()
            assert mesh.mesh_dim_names == shape.mesh_dim_names and tuple(mesh.shape) == shape.shape
        assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with fake_mesh(small_shape(), "cpu"):
            raise ValueError("the step failed")
    assert not dist.is_initialized()


# --------------------------------------------------------------------------
# the traffic model, rule by rule
# --------------------------------------------------------------------------
def _only(trace, name):
    ops_ = [op for op in trace.ops if op["op"] == name]
    assert len(ops_) == 1, [op["op"] for op in trace.ops]
    return ops_[0]


def test_traffic_rules_in_closed_form():
    f32 = 4
    a, b, buf, v = fake((64, 32), (64, 32), (128, 32), (8, 32))
    with _mode_of(a):
        idx = torch.arange(8)
        gidx = torch.zeros((8, 32), dtype=torch.long)

    def step(a, b, buf, v, idx, gidx):
        s = a + b                                         # operands + result
        t = s.t()                                         # a view: 0
        w = s.view(-1)                                    # a view: 0
        rows = torch.index_select(a, 0, idx)              # 2 x the result
        g = a.gather(0, gidx)                             # 2 x the result
        i = a[idx]                                        # aten::index: 2 x the result
        # lint: disable=R1 -- a traffic-model fixture, no cache
        buf.index_put_((idx,), v)                         # 3 x the update
        # lint: disable=R1 -- a traffic-model fixture, no cache
        buf.index_copy_(0, idx, v)                        # 3 x the source
        # lint: disable=R1 -- a traffic-model fixture, no cache
        buf.scatter_(0, gidx, v)                          # 3 x the source
        return t, w, rows, g, i

    trace, _ = trace_step(step, a, b, buf, v, idx, gidx)
    assert op_traffic(_only(trace, "aten::add")) == 3 * 64 * 32 * f32
    assert op_traffic(_only(trace, "aten::t")) == 0
    assert op_traffic(_only(trace, "aten::view")) == 0
    assert op_traffic(_only(trace, "aten::index_select")) == 2 * 8 * 32 * f32
    assert op_traffic(_only(trace, "aten::gather")) == 2 * 8 * 32 * f32
    assert op_traffic(_only(trace, "aten::index")) == 2 * 8 * 32 * f32
    assert op_traffic(_only(trace, "aten::index_put_")) == 3 * 8 * 32 * f32
    assert op_traffic(_only(trace, "aten::index_copy_")) == 3 * 8 * 32 * f32
    assert op_traffic(_only(trace, "aten::scatter_")) == 3 * 8 * 32 * f32
    st = step_stats(trace)
    assert st.traffic_bytes == sum(op_traffic(op) for op in trace.ops)
    assert st.memory["alias_size_in_bytes"] == 128 * 32 * f32      # buf, written in place


def _mode_of(t):
    from repro_torch.roofline.hlo_stats import fake_mode_of

    return fake_mode_of([t])


def test_kernel_operators_charge_their_cost():
    """An mpGeMM operator charges `mpgemm_cost` (times its experts), flash
    4·B·H·D per valid pair and its q, k, v and output bytes."""
    m, kg, n, g, e = 48, 12, 5, 5, 3
    mode = FakeTensorMode()
    with mode:
        packed = torch.empty((m, kg), dtype=torch.uint8)
        x = torch.empty((n, kg * g))
        a_scale, w_scale = torch.empty((n,)), torch.empty((m,))
        gp, gx = torch.empty((e, m, kg), dtype=torch.uint8), torch.empty((e, n, kg * g))
        a_r = torch.empty((g, kg, n), dtype=torch.int8)
        q = torch.empty((2, 6, 40, 16))
        k = torch.empty((2, 3, 40, 16))

    def step():
        return (tdg.ternary_decode_gemm_fused(packed, x, a_scale, w_scale, g=g),
                vlg.vlut_lookup_gemm_fused_grouped(gp, gx, torch.empty((e, n)),
                                                   torch.empty((e, m)), g=g),
                tdg.ternary_decode_gemm(packed, a_r, g=g),
                fa.flash_attention(q, k, k, causal=True, window=8))

    trace, _ = trace_step(lambda *_: step(), packed)
    kern = [op for op in trace.ops if op["op"].startswith("repro_torch::")]
    assert [op["op"] for op in kern] == [
        "repro_torch::ternary_decode_gemm_fused", "repro_torch::vlut_lookup_gemm_fused_grouped",
        "repro_torch::ternary_decode_gemm", "repro_torch::flash_attention"]
    fused = mpgemm_cost(m, kg * g, n, g, fused=True)
    integer = mpgemm_cost(m, kg * g, n, g, fused=False)
    pairs = sum(min(i, 39) - max(0, i - 7) + 1 for i in range(40))
    flash = (4.0 * 2 * 6 * 16 * pairs, 4.0 * (2 * 2 * 6 * 40 * 16 + 2 * 2 * 3 * 40 * 16))
    st = step_stats(trace)
    assert st.kernel_flops == fused[0] + e * fused[0] + integer[0] + flash[0]
    assert st.kernel_bytes == fused[1] + e * fused[1] + integer[1] + flash[1]
    assert [op_traffic(op) for op in kern] == [fused[1], e * fused[1], integer[1], flash[1]]
    assert st.launches == {"ternary_decode_gemm_fused": 1, "vlut_lookup_gemm_fused_grouped": 1,
                           "ternary_decode_gemm": 1, "flash_attention": 1}


def test_trace_round_trips_for_offline_reanalysis(tmp_path):
    a, b = fake((32, 16), (16, 8))
    trace, _ = trace_step(lambda a, b: torch.relu(a @ b), a, b)
    path = tmp_path / "t.json.xz"
    path.write_bytes(lzma.compress(trace.to_json().encode()))
    again = Trace.from_json(lzma.decompress(path.read_bytes()).decode())
    assert step_stats(again) == step_stats(trace)
    assert isinstance(step_stats(again), HloStats)


# --------------------------------------------------------------------------
# the kernel operators
# --------------------------------------------------------------------------
def _fused_inputs(rng, lead=(), m=48, kg=12, n=5, g=5):
    packed = torch.from_numpy(rng.integers(0, 3 ** g, (*lead, m, kg)).astype(np.uint8))
    x = torch.from_numpy(rng.standard_normal((*lead, n, kg * g)).astype(np.float32))
    a_scale = act_token_scale(x.reshape(-1, kg * g).T).reshape(*lead, n).contiguous()
    w_scale = torch.from_numpy(rng.uniform(0.5, 1.5, (*lead, m)).astype(np.float32))
    return packed, x, a_scale, w_scale


def _int_inputs(rng, lead=(), m=48, kg=12, n=6, g=4):
    packed = torch.from_numpy(rng.integers(0, 3 ** g, (*lead, m, kg)).astype(np.uint8))
    a_r = torch.from_numpy(rng.integers(-127, 128, (*lead, g, kg, n)).astype(np.int8))
    return packed, a_r


FUSED = [("ternary_decode_gemm_fused", tdg.ternary_decode_gemm_fused,
          tdg.ternary_decode_gemm_fused_plain, ()),
         ("vlut_lookup_gemm_fused", vlg.vlut_lookup_gemm_fused,
          vlg.vlut_lookup_gemm_fused_plain, ()),
         ("ternary_decode_gemm_fused_grouped", tdg.ternary_decode_gemm_fused_grouped,
          tdg.ternary_decode_gemm_fused_plain, (3,)),
         ("vlut_lookup_gemm_fused_grouped", vlg.vlut_lookup_gemm_fused_grouped,
          vlg.vlut_lookup_gemm_fused_plain, (3,))]
INTEGER = [("ternary_decode_gemm", tdg.ternary_decode_gemm, tdg.ternary_decode_gemm_plain, ()),
           ("vlut_lookup_gemm", vlg.vlut_lookup_gemm, vlg.vlut_lookup_gemm_plain, ()),
           ("ternary_decode_gemm_grouped", tdg.ternary_decode_gemm_grouped,
            tdg.ternary_decode_gemm_plain, (2,)),
           ("vlut_lookup_gemm_grouped", vlg.vlut_lookup_gemm_grouped,
            vlg.vlut_lookup_gemm_plain, (2,))]


def _check_operator(name, wrapper, cpu_out, plain_out, args, kwargs, op_args):
    """The CPU implementation is the plain version bit for bit and the
    wrapper's direct route agrees; the fake implementation gives its
    shape, dtype and strides; a fake tensor reaching the wrapper is one
    operator in a trace and moves no counter."""
    assert torch.equal(cpu_out, plain_out)
    assert torch.equal(wrapper(*args, **kwargs), cpu_out)
    mode = FakeTensorMode()
    fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in op_args]
    with mode:
        fout = getattr(torch.ops.repro_torch, name)(*fargs)
    assert (fout.shape, fout.dtype, fout.stride()) == (cpu_out.shape, cpu_out.dtype,
                                                       cpu_out.stride())
    fwargs = [mode.from_tensor(a) for a in args]
    before = wrapper.launches
    trace, out = trace_step(lambda *t: wrapper(*t, **kwargs), *fwargs)
    assert [op["op"] for op in trace.ops if op["op"].startswith("repro_torch::")] == [
        f"repro_torch::{name}"]
    assert (out.shape, out.dtype, out.stride()) == (cpu_out.shape, cpu_out.dtype, cpu_out.stride())
    assert wrapper.launches == before


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,wrapper,plain,lead", FUSED, ids=[f[0] for f in FUSED])
def test_fused_operator(name, wrapper, plain, lead, out_dtype):
    packed, x, a_scale, w_scale = _fused_inputs(np.random.default_rng(11), lead)
    cpu = getattr(torch.ops.repro_torch, name)(packed, x, a_scale, w_scale, 5, out_dtype, None)
    _check_operator(name, wrapper, cpu,
                    plain(packed, x, a_scale, w_scale, g=5, out_dtype=out_dtype),
                    (packed, x, a_scale, w_scale), {"g": 5, "out_dtype": out_dtype},
                    (packed, x, a_scale, w_scale, 5, out_dtype, None))


@pytest.mark.parametrize("name,wrapper,plain,lead", INTEGER, ids=[f[0] for f in INTEGER])
def test_integer_operator(name, wrapper, plain, lead):
    packed, a_r = _int_inputs(np.random.default_rng(12), lead)
    cpu = getattr(torch.ops.repro_torch, name)(packed, a_r, 4, None)
    _check_operator(name, wrapper, cpu, plain(packed, a_r, g=4), (packed, a_r), {"g": 4},
                    (packed, a_r, 4, None))


@pytest.mark.parametrize("window", [0, 7])
def test_flash_operator(window):
    """q, k, v as the model passes them: transposed views of (B, S, H, D);
    the operator's output is laid out like q, on both implementations."""
    rng = np.random.default_rng(13)
    q = torch.from_numpy(rng.standard_normal((2, 24, 6, 16)).astype(np.float32)).transpose(1, 2)
    k = torch.from_numpy(rng.standard_normal((2, 24, 3, 16)).astype(np.float32)).transpose(1, 2)
    v = torch.from_numpy(rng.standard_normal((2, 24, 3, 16)).astype(np.float32)).transpose(1, 2)
    cpu = torch.ops.repro_torch.flash_attention(q, k, v, True, window, 0.0)
    plain = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    assert cpu.stride() == torch.empty_like(q).stride()
    assert torch.equal(cpu, plain)
    assert torch.equal(fa.flash_attention(q, k, v, causal=True, window=window), plain)
    mode = FakeTensorMode()
    fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
    with mode:
        fout = torch.ops.repro_torch.flash_attention(fq, fk, fv, True, window, 0.0)
    assert (fout.shape, fout.dtype, fout.stride()) == (cpu.shape, cpu.dtype, cpu.stride())
    before = fa.flash_attention.launches
    trace, out = trace_step(
        lambda q, k, v: fa.flash_attention_trainable(q, k, v, True, window), fq, fk, fv)
    assert [op["op"] for op in trace.ops if op["op"].startswith("repro_torch::")] == [
        "repro_torch::flash_attention"]
    assert out.stride() == cpu.stride() and fa.flash_attention.launches == before


def test_plan_crosses_the_schema():
    """Every plan class survives its trip through the operators' `int[]?`."""
    plans = [tdg.decode_plan(960, 192, 4, 5), tdg.decode_plan(960, 192, 4, 5, codes_aligned=True,
                                                               acts_aligned=True),
             tdg.grouped_decode_plan(1024, 512, 16, 5, 16), vlg.lut_plan(960, 192, 4, 5),
             vlg.grouped_lut_plan(1024, 512, 4, 5, 16)]
    for p in plans:
        fields = _library.plan_fields(p)
        assert all(type(v) is int for v in fields)
        back = _library.plan_from(type(p), fields)
        assert back == p and all(type(getattr(back, f)) is type(getattr(p, f))
                                 for f in p.__dataclass_fields__)
    assert _library.plan_fields(None) is None and _library.plan_from(tdg.DecodePlan, None) is None


# --------------------------------------------------------------------------
# small-config smollm traces
# --------------------------------------------------------------------------
def _predicted_launches(cfg, n: int, impl: str = "decode", fusion: str = "fused") -> int:
    """Σ over the packed linears of one forward at N tokens of the launches
    `launch_tiles` reports (one a packed segment)."""
    model = pack_params(init_lm(cfg, torch.Generator().manual_seed(0)), cfg)
    return sum(len(ops.launch_tiles(mod.pw, n, impl, fusion=fusion)) for mod in model.modules()
               if isinstance(mod, PackedLinear))


@pytest.mark.parametrize("impl", ["decode", "lookup"])
def test_smollm_decode_trace(impl):
    cfg = get_config("smollm-360m", smoke=True)
    mode = FakeTensorMode()
    model = fake_module(meta_model(cfg, packed=True), "cpu", mode)
    with mode:
        cache = init_cache(cfg, 4, 64, dtype=torch.bfloat16, device="cpu")
        tok = torch.zeros((4, 1), dtype=torch.int32)
    step = make_decode_step(cfg, device="cpu")
    with ops.dispatch_override(impl=impl):
        trace, (nxt, _) = trace_step(step, model, cache, tok)
        with mode, FlopCounterMode(display=False) as fc:
            step(model, cache, tok)
    st = step_stats(trace)
    kernel = {"decode": "ternary_decode_gemm_fused", "lookup": "vlut_lookup_gemm_fused"}[impl]
    assert st.launches == {kernel: _predicted_launches(cfg, 4, impl)}
    assert st.dot_flops == fc.get_total_flops() > 0
    assert nxt.shape == (4,) and nxt.dtype == torch.int32
    m = st.memory
    assert m["argument_size_in_bytes"] > 0 and m["temp_size_in_bytes"] > 0
    assert m["alias_size_in_bytes"] > 0             # the cache, written in place
    assert st.collectives == {} and st.traffic_bytes > st.kernel_bytes > 0


def test_smollm_prefill_trace_unfused():
    """The unfused pipeline launches the integer kernel once a segment."""
    cfg = get_config("smollm-360m", smoke=True)
    mode = FakeTensorMode()
    model = fake_module(meta_model(cfg, packed=True), "cpu", mode)
    with mode:
        cache = init_cache(cfg, 2, 64, dtype=torch.bfloat16, device="cpu")
        batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32)}
    with ops.dispatch_override(fusion="unfused"):
        trace, _ = trace_step(make_prefill_step(cfg, device="cpu"), model, cache, batch)
    assert step_stats(trace).launches == {
        "ternary_decode_gemm": _predicted_launches(cfg, 32, fusion="unfused")}


def test_smollm_training_trace():
    """One QAT step (forward, backward, AdamW) with the flash kernel: one
    launch a layer, twice under remat; `dot_flops` = FlopCounterMode's."""
    cfg = get_config("smollm-360m", smoke=True).with_(attn_impl="flash")
    opt_cfg = AdamWConfig()
    mode = FakeTensorMode()
    model = fake_module(meta_model(cfg), "cpu", mode).requires_grad_(True)
    with mode:
        params = dict(model.named_parameters())
        state = {"params": params, "opt": adamw_init(params, opt_cfg, stacked_shapes(model, cfg))}
        batch = {"tokens": torch.zeros((2, 32), dtype=torch.int32),
                 "labels": torch.zeros((2, 32), dtype=torch.int32)}
    step = make_train_step(cfg, opt_cfg)
    trace, _ = trace_step(step, model, state, batch)
    st = step_stats(trace)
    assert st.launches == {"flash_attention": cfg.n_layers * (2 if cfg.remat else 1)}
    with mode, FlopCounterMode(display=False) as fc:
        step(model, state, batch)
    assert st.dot_flops == fc.get_total_flops() > 0
    m = st.memory
    # the parameters (updated in place) are aliased; the old moments are freed
    assert m["alias_size_in_bytes"] >= sum(p.untyped_storage().nbytes() for p in params.values())
    assert m["temp_size_in_bytes"] > 0
    assert any(op["op"] == "aten::mm" for op in trace.ops)          # the backward's products


# --------------------------------------------------------------------------
# the dry run on small meshes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind,multi_pod", [("train", False), ("decode", True)])
def test_trace_cell_small_mesh(kind, multi_pod):
    """The dry run's trace of a smoke-size cell on DTensors over the small
    fake mesh: collectives appear, the serving step runs the "xla" impl
    (no kernel operator: DTensors never reach a kernel)."""
    cfg = get_config("smollm-360m", smoke=True).with_(max_cache_len=64)
    shape = ShapeConfig("cell", 64, 8, kind)
    with fake_mesh(small_shape(multi_pod=multi_pod), "cpu") as mesh:
        trace, st = dryrun.trace_cell(cfg, shape, mesh, "cpu")
    assert not dist.is_initialized()
    assert st.collective_bytes > 0 and st.dot_flops > 0 and st.traffic_bytes > 0
    assert st.launches == {}
    assert all(v is not None for v in st.memory.values())


@pytest.mark.parametrize("arch,kind,batch,multi_pod", [
    ("smollm-360m", "train", 8, False),
    ("smollm-360m", "prefill", 8, False),
    ("smollm-360m", "decode", 1, True),            # B 1: the 3-D mesh, traced as it is
    ("deepseek-v3-671b", "prefill", 8, False),
])
def test_greedy_prices_leave_the_trace_unchanged(arch, kind, batch, multi_pod):
    """The dry run prices DTensor's candidate strategies by its greedy
    planner (`_dtensor_for_tracing`); propagation picks each op's strategy
    by those prices. On smoke-size small-mesh cells the recorded op stream
    is the one DTensor's own prices give (the strategy cache cleared before
    each trace). The first trace starts from DTensor's cold global-shape
    propagation, the second finds it cached: the same stream also shows
    that propagation stays out of the record."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    cfg = get_config(arch, smoke=True).with_(max_cache_len=64)
    shape = ShapeConfig("cell", 64, batch, kind)
    mesh_shape = dryrun.trace_shape(small_shape(multi_pod=multi_pod), shape)
    assert len(mesh_axes(mesh_shape)) == (3 if multi_pod else 2)
    ShardingPropagator._propagate_tensor_meta_cached.cache_clear()
    streams = []
    for greedy in (True, False):
        DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()
        with fake_mesh(mesh_shape, "cpu") as mesh:
            trace, _ = dryrun.trace_cell(cfg, shape, mesh, "cpu", greedy_prices=greedy)
        streams.append(trace.ops)
    assert len(streams[0]) > 0 and streams[0] == streams[1]


def test_a_missing_patch_target_raises(monkeypatch):
    """A torch without one of the DTensor internals the trace adapts fails
    the trace, never runs it unadapted."""
    monkeypatch.setattr(dryrun, "_DTENSOR_COSTS",
                        (*dryrun._DTENSOR_COSTS, ("torch.distributed.tensor._utils", "no_such")))
    with pytest.raises(RuntimeError, match="no_such"):
        with dryrun._dtensor_for_tracing():
            pass


def test_run_cell_fills_the_compile_side_fields(tmp_path, monkeypatch):
    """A full-width cell on the small mesh: memory analysis, lower_s, a
    numeric collective term, the saved graph; compile_s, xla_cost_analysis
    and hlo_bytes null; bytes_per_device as before."""
    monkeypatch.chdir(tmp_path)
    rec = dryrun.run_cell("mamba2-1.3b", "long_500k", small_mesh=True, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert set(rec["memory_analysis"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                           "alias_size_in_bytes", "temp_size_in_bytes"}
    assert rec["lower_s"] > 0 and isinstance(rec["roofline"]["collective_s"], float)
    assert rec["compile_s"] is None and rec["xla_cost_analysis"] is None
    assert rec["hlo_bytes"] is None and rec["n_whiles"] is None
    assert rec["state_bytes_per_device"] == rec["bytes_per_device"]["params"] + \
        rec["bytes_per_device"]["cache"]
    trace = Trace.from_json(lzma.decompress((tmp_path / rec["graph_path"]).read_bytes()).decode())
    st = step_stats(trace)
    assert rec["memory_analysis"] == st.memory
    assert rec["roofline"]["collective_s"] == st.collective_bytes / LINK_BW
    assert rec["roofline"]["memory_s"] == st.traffic_bytes / HBM_BW
    assert rec["roofline"]["compute_s"] == st.flops / PEAK_FLOPS
