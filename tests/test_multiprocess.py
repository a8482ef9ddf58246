"""TRUE multi-process validation of the multi-host path.

The reference tests multi-node by oversubscribing MPI ranks on one
machine (tests/Makefile:78-84).  The analog here: two OS processes, each
with 4 virtual CPU devices, joined through jax.distributed — a real
cross-process runtime, not the single-process virtual mesh.  Exercises
initialize_distributed, make_multihost_mesh (dcn_axis placement without
slice topology), a global reduction, a cross-process ppermute (the halo
primitive), and the blocked-run explicit redistribution over the global
8-rank mesh, all against host oracles.
"""

import os
import socket
import subprocess
import sys

_WORKER = r'''
import dataclasses, os, sys
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["SBT_DEBUG"] = "1"   # arm the cross-process consistency net
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.getcwd())   # launched with cwd = repo root
from superbblas_tpu.parallel import (initialize_distributed,
                                     make_multihost_mesh)
initialize_distributed(coordinator_address=f"localhost:{port}",
                       num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc
import numpy as np
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

n = nproc * 4
mesh = make_multihost_mesh({"x": n}, dcn_axis="x")

# 1. global reduction across processes
x = jnp.arange(n * 8, dtype=jnp.float64)
xs = jax.device_put(x.reshape(n, 8), NamedSharding(mesh, P("x", None)))
assert float(jax.jit(jnp.sum)(xs)) == float(np.arange(n * 8).sum())

# 2. cross-process ppermute (halo primitive)
rolled = shard_map(
    lambda a: jax.lax.ppermute(a, "x", [(i, (i + 1) % n) for i in range(n)]),
    mesh=mesh, in_specs=P("x", None), out_specs=P("x", None),
    check_vma=False)(xs)
jax.block_until_ready(rolled)

# 3. the SoA sharded stencil hot path ACROSS processes: halo ppermute
# crosses the process boundary on the global mesh
from superbblas_tpu.models import wilson_operator
from superbblas_tpu.parallel import apply_stencil_soa_sharded
from superbblas_tpu import cplx
mesh2 = make_multihost_mesh({"d": n}, dcn_axis="d")
lat = (2 * n, 4, 8, 128)
op = wilson_operator(lat, mass=0.2, key=0, dtype=jnp.complex64,
                     layout="soa")
spec = P(None, None, "d", None, None, None)
rng0 = np.random.default_rng(0)
shp = (1, 12) + lat
xs0 = cplx.CArray(jnp.asarray(rng0.standard_normal(shp), jnp.float32),
                  jnp.asarray(rng0.standard_normal(shp), jnp.float32))
op_sh = dataclasses.replace(op, blocks=jax.device_put(
    op.blocks, NamedSharding(mesh2, spec)))
x_sh = jax.device_put(xs0, NamedSharding(mesh2, spec))
y = apply_stencil_soa_sharded(op_sh, x_sh, mesh2, {"x": "d"})
from superbblas_tpu.bsr import apply_stencil_soa
want = apply_stencil_soa(op, xs0)       # local XLA reference
got = jax.device_put(y, NamedSharding(mesh2, P()))   # replicate to host
err = float(jnp.max(jnp.abs(got.re - want.re))
            + jnp.max(jnp.abs(got.im - want.im)))
assert err < 1e-3, f"cross-process SoA stencil mismatch: {err}"

# 4. blocked-run explicit redistribution over the global mesh
from superbblas_tpu import parallel as par
from superbblas_tpu.parallel import redistribute as R
dim = (16, 12)
src = par.basic_partitioning("xy", dim, (n, 1))
dst = par.basic_partitioning("xy", dim, (2, 4))
gx = np.arange(np.prod(dim), dtype=np.float64).reshape(dim)
stack = jax.device_put(jnp.asarray(R.pack_global(gx, src)),
                       NamedSharding(mesh, P("x", None, None)))
out = R.redistribute_explicit(stack, src, dst, mesh, axis="x")
got = R.unpack_global(
    np.asarray(jax.device_put(
        out, NamedSharding(mesh, P(None, None, None)))), dst)
assert np.array_equal(got, gx), "cross-process redistribution mismatch"

# 5. coordinated multi-process storage: create/declare on process 0 with
# barriers (storage._declare_coordinated), every process writes only ITS
# addressable shards to the shared file, a single trailer CRC from
# process 0 — the MPI-IO collective-write analog (storage.h:202-342).
# Re-open and verify both contents and the level-1 global checksum.
from superbblas_tpu import storage as S
spath = sys.argv[4]
gdim = (n * 4, 6)
sto = S.create_storage_sharded(spath, "xy", gdim, dtype=np.float64,
                               checksum=1)
gx2 = np.arange(np.prod(gdim), dtype=np.float64).reshape(gdim)
xs2 = jax.device_put(jnp.asarray(gx2), NamedSharding(mesh, P("x", None)))
S.save_sharded(sto, xs2, "xy")
S.close_storage_sharded(sto)
if pid == 0:
    back = S.open_storage(spath, mode="r")
    S.check_or_write_checksums(back)      # verifies the trailer CRC chain
    rd = np.asarray(S.load_sharded(
        back, NamedSharding(mesh, P(None, None))).addressable_shards[0].data)
    assert np.array_equal(rd, gx2), "coordinated storage round-trip mismatch"
    S.close_storage(back)
# 6. ASYNC coordinated writes: save_sharded_async from both processes
# concurrently (the declare/barrier protocol must serialize the chunk
# append while the block writes themselves race on the IO pool — the
# MPI_File_iwrite analog, storage.h:294-306), then the reference-format
# trailer CRC must still verify.
spath2 = spath + ".async"
sto2 = S.create_storage_sharded(spath2, "xy", gdim, dtype=np.float64,
                                checksum=1)
fut = S.save_sharded_async(sto2, xs2, "xy")
fut.result()
S.close_storage_sharded(sto2)
if pid == 0:
    back2 = S.open_storage(spath2, mode="r")
    S.check_or_write_checksums(back2)
    rd2 = np.asarray(S.load_sharded(
        back2, NamedSharding(mesh, P(None, None))).addressable_shards[0].data)
    assert np.array_equal(rd2, gx2), "async coordinated storage mismatch"
    S.close_storage(back2)

# 7. REGRESSION (round-4 VERDICT item 1): forced declare SKEW.  Process 1
# stalls its create-time open, so process 0 sprints ahead — its first
# save_sharded APPENDS blocks to the file BEFORE process 1 ever reads it.
# Process 1 then opens a file whose block table is already non-empty.
# The old conditional declare (`if not sto.blocks:`) skipped the declare
# barrier on process 1 here and desynchronized the barrier schedule
# (sync_global_devices name mismatch); the fix enters _declare_coordinated
# unconditionally and lets process 0 decide under the barrier.
import time
_orig_open = S.open_storage
_slept = [False]
def _slow_open(path, mode="r"):
    if pid != 0 and path.endswith(".skew") and not _slept[0]:
        _slept[0] = True
        time.sleep(2.0)      # let process 0 reach its save + append first
    return _orig_open(path, mode)
S.open_storage = _slow_open
spath3 = spath + ".skew"
sto3 = S.create_storage_sharded(spath3, "xy", gdim, dtype=np.float64,
                                checksum=1)
S.save_sharded(sto3, xs2, "xy")
S.save_sharded(sto3, xs2, "xy")   # second save: already-declared branch
S.close_storage_sharded(sto3)
S.open_storage = _orig_open
if pid == 0:
    back3 = S.open_storage(spath3, mode="r")
    S.check_or_write_checksums(back3)
    rd3 = np.asarray(S.load_sharded(
        back3, NamedSharding(mesh, P(None, None))).addressable_shards[0].data)
    assert np.array_equal(rd3, gx2), "skewed-declare round-trip mismatch"
    S.close_storage(back3)

# 8. the SBT_DEBUG>=1 net CATCHES divergence: feed it the round-4 bug's
# exact shape — a declare decision branched on locally-divergent state.
# All processes must raise TOGETHER (allgather, not broadcast+compare).
from superbblas_tpu.utils import check_collective_consistency
check_collective_consistency("sbt:test:agree", ("decision", True))
try:
    check_collective_consistency("sbt:test:diverge", ("decision", pid == 0))
except RuntimeError as e:
    assert "divergence" in str(e)
else:
    raise AssertionError("consistency net missed a divergent payload")
print(f"proc {pid}: MULTIPROCESS_OK", flush=True)
'''


def test_two_process_distributed(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    # find a free port
    s = socket.socket()
    s.bind(("localhost", 0))
    port = str(s.getsockname()[1])
    s.close()

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    spath = str(tmp_path / "coord.s3t")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), "2", port, spath],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, text=True) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "MULTIPROCESS_OK" in out, (
            f"proc {pid} failed:\n{out[-3000:]}")
