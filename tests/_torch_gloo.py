"""Ranks of a gloo process group for the port's multi-device tests
(tests/test_torch_parallel.py, tests/test_torch_prover_sharded.py).

``run_ranks(fn, D, tmp_dir, *args)`` spawns D processes that join one
gloo group over a ``file://`` rendezvous in ``tmp_dir`` (no TCP port, so
that parallel test workers never collide), each with one torch thread; rank
r runs ``fn(r, D, *args)`` and the results come back through a queue, by
rank. The rank functions below import only torch and the port.
"""
import datetime
import multiprocessing
import os
import queue
import traceback

RANK_TIMEOUT_S = 240


def _rank_main(fn, rank, D, init, q, args):
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=init, world_size=D, rank=rank,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            q.put((rank, "ok", fn(rank, D, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))


def run_ranks(fn, D: int, tmp_dir, *args) -> list:
    """fn(rank, D, *args) on each of D gloo ranks; the results by rank.
    Raises with the rank's traceback if one fails."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    init = "file://" + os.path.join(str(tmp_dir), f"rendezvous_{D}")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, D, init, q, args))
             for r in range(D)]
    for p in procs:
        p.start()
    out = [None] * D
    try:
        for _ in range(D):
            rank, status, res = q.get(timeout=RANK_TIMEOUT_S + 60)
            if status != "ok":
                raise AssertionError(f"rank {rank} of {D} failed:\n{res}")
            out[rank] = res
    except queue.Empty:
        raise AssertionError(f"the ranks of {D} gave no result in time")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    return out


# ----------------------------------------------------------------- ranks

def proof_coords(proof):
    """A Groth16 proof as plain integers (picklable, comparable)."""
    g1 = lambda P: None if P.is_zero() else (int(P.x), int(P.y))
    g2 = lambda P: None if P.is_zero() else (
        (int(P.x.c0), int(P.x.c1)), (int(P.y.c0), int(P.y.c1)))
    return (g1(proof.g_A), g2(proof.g_B), g1(proof.g_C))


def affine_coords(ck, aff, group):
    """Device affine points as host (x, y) integers (None: infinity)."""
    out = []
    for P in ck.decode_affine(aff, group):
        out.append(None if P.is_zero() else (int(P.x), int(P.y)))
    return out


def parallel_checks(rank, D, msm_cases, methods, ntt_vals=None,
                    two_vals=None):
    """The port's sharded_msm (each of ``methods``, each case's points and
    scalars: (xs, ys, scalars) host integers), and with values given
    FourStepDomain at logm 6 (fft, ifft, the coset round trip,
    icoset_fft_divz) and ShardedTwoPartDomain(4, 2) (fft, ifft, the coset
    round trip) over the rank's group, alt_bn128. Returns plain integers
    and numpy limbs."""
    import torch
    from libsnark_tpu_torch import get_curve
    from libsnark_tpu_torch.ops.limbs import from_torch, ints_to_limbs
    from libsnark_tpu_torch.parallel.msm_sharded import (pad_for_mesh,
                                                         sharded_msm)
    from libsnark_tpu_torch.parallel.ntt_sharded import (
        FourStepDomain, ShardedTwoPartDomain)
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16
    curve = get_curve("alt_bn128")
    g = Groth16(curve, device="cpu")
    fq, fr = g.fq, g.fr
    out = {"msm": {}}
    for m, (xs, ys, scalars) in msm_cases.items():
        pts = (fq.encode(xs), fq.encode(ys),
               torch.zeros(len(xs), dtype=torch.bool))
        sc = torch.from_numpy(ints_to_limbs(scalars, 16).astype("int32"))
        pts, sc = pad_for_mesh(pts, sc, D)
        for method in methods:
            aff = sharded_msm(g.msm_g1, None, pts, sc, c=5, affine=True,
                              method=method)
            out["msm"][m, method] = affine_coords(g.g1, aff, curve.G1)
    if ntt_vals is None:
        return out
    dom = FourStepDomain(fr, curve.fr_params, 6)
    a = fr.encode(ntt_vals)
    f = dom.fft(a)
    out["four_step"] = [from_torch(t) for t in (
        f, dom.ifft(f), dom.icoset_fft(dom.coset_fft(a)),
        dom.icoset_fft_divz(a))]
    two = ShardedTwoPartDomain(fr, curve.fr_params, 4, 2)
    b = fr.encode(two_vals)
    f = two.fft(b)
    out["two_part"] = [from_torch(t) for t in (
        f, two.ifft(f), two.icoset_fft(two.coset_fft(b)))]
    out["two_part_kinds"] = (type(two.dom1).__name__,
                             type(two.dom2).__name__)
    return out


def sharded_proofs(rank, D, cases, verify=False):
    """prover_sharded over the rank's group for each (constraints, key
    seed, proof seed) case of generate_r1cs_example(r, constraints, 2)
    over alt_bn128 (keys on the host, as in the JAX package's test).
    Returns {constraints: the proof's coordinates, the domain's type and
    size}; with verify, the verifier's checks of the sharded proofs (for
    each case: accepted, then rejected for a changed primary input) are
    dealt out over the ranks, each rank's verdicts under "verdicts"."""
    from libsnark_tpu_torch import get_curve
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16
    from libsnark_tpu_torch.relations.examples import generate_r1cs_example
    curve = get_curve("alt_bn128")
    out, checks = {}, []
    for nc, kseed, pseed in cases:
        cs, primary, aux = generate_r1cs_example(curve.r, nc, 2)
        g = Groth16(curve, device="cpu")
        g.host_keygen = True
        kp = g.generator(cs, seed=kseed)
        proof = g.prover_sharded(kp.pk, primary, aux, seed=pseed)
        dom = [d for k, d in g._domains.items() if k[0] == "sharded"][0]
        out[nc] = {"proof": proof_coords(proof),
                   "domain": (type(dom).__name__, dom.m)}
        bad = [(primary[0] + 1) % curve.r] + list(primary[1:])
        checks += [(nc, "accepted", g, kp.vk, primary, proof),
                   (nc, "changed-input", g, kp.vk, bad, proof)]
    if verify:
        out["verdicts"] = {(nc, what): g.verifier_strong_IC(vk, prim, pr)
                           for i, (nc, what, g, vk, prim, pr)
                           in enumerate(checks) if i % D == rank}
    return out
