"""Helpers of chip_smoke.py that run without a card: the rate probes'
bounds from the instructions a step needs or a listing holds, and the labels that charge
each torch operation to the port function that issued it (behind its
split of torch's own device operations by caller)."""
import pytest

torch = pytest.importorskip("torch")

import chip_smoke
from libsnark_tpu_torch import get_curve, probes
from libsnark_tpu_torch.ops.fp import FpKernel


def test_rate_bound_counts_each_step_instruction_at_the_lane_rate():
    steps = 1000 * probes.CHAINS * probes.RATE_UNROLL
    lane = chip_smoke.INT32_LANE_OPS_PER_S
    wide = {"IMAD.WIDE.U32": 1}
    one = chip_smoke.rate_bound_ms(wide, steps, 1)
    assert one == pytest.approx(steps / lane * 1e3)
    assert chip_smoke.rate_bound_ms(wide, steps, 2) == pytest.approx(2 * one)
    # the tables' convention: a wide multiply-add at INT32_OPS_PER_S
    assert chip_smoke.rate_bound_ms(wide, steps, chip_smoke.WIDE_SLOTS) \
        == pytest.approx(steps / chip_smoke.INT32_OPS_PER_S * 1e3)
    split = {"IMAD.WIDE.U32": 1, "IADD3": 1, "IADD3.X": 0.5}
    assert chip_smoke.rate_bound_ms(split, steps, 1) == pytest.approx(2.5 * one)
    assert chip_smoke.rate_bound_ms({"FMUL": 1}, steps, 2) == \
        pytest.approx(steps / chip_smoke.F32_MUL_PER_S * 1e3)


@pytest.mark.parametrize("op,lane_slots", [
    ("mul_lo", 1), ("mad_lo", 1), ("mad_hi", 1), ("add64", 1),
    ("shift_and", 2), ("mad_wide", 2), ("mad_wide_split", 2), ("mad_cc", 2),
    ("mul_f32", 0)])
def test_rate_bound_is_what_each_step_needs(op, lane_slots):
    """Each rate probe's bound counts the instructions its step needs, not
    the moves a listing may hold beside them: one lane instruction for the
    32-bit multiplies and the 64-bit add, two for shift-and, one IMAD.WIDE
    at WIDE_SLOTS for the three wide multiply-add forms, the f32 rate for
    mul_f32."""
    assert set(chip_smoke.RATE_STEP) == set(probes.RATE_OPS)
    steps = 1 << 20
    got = chip_smoke.rate_bound_ms(chip_smoke.RATE_STEP[op], steps,
                                   chip_smoke.WIDE_SLOTS)
    want = (steps / chip_smoke.F32_MUL_PER_S if op == "mul_f32"
            else lane_slots * steps / chip_smoke.INT32_LANE_OPS_PER_S)
    assert got == pytest.approx(want * 1e3)


def test_port_callers_label_each_operation_with_the_port_functions():
    """Under PortCallers every operator of a field add sits below one label
    naming the port's innermost function above it (the carry
    normalisation) and the functions that called it; an operator issued
    outside the port carries none. (More lanes than cuda_fp.SMALL_LANES:
    fewer take the Python-integer form on the CPU, as no card tensor
    does.)"""
    from torch.profiler import ProfilerActivity, profile
    from libsnark_tpu_torch.ops import cuda_fp
    fk = FpKernel(get_curve("alt_bn128").fq_params, device="cpu")
    n = 2 * cuda_fp.SMALL_LANES
    a, b = fk.encode(range(1, n + 1)), fk.encode(range(n + 1, 2 * n + 1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with chip_smoke.PortCallers():
            fk.add(a, b)
            torch.ones(3) + 1
    ops = [e for e in prof.events() if e.name.startswith("aten::")]
    chains = {tuple(chip_smoke.port_callers(e)) for e in ops}
    assert ("ops/cuda_fp.py:normalize", "ops/fp.py:add") in chains
    assert all(len(c) <= 3 for c in chains)
    assert () in chains                   # the add outside the port


def test_pairing_pool_gives_the_port_checks_verdicts():
    """VerifierPool: whole verifier calls run in worker processes, on a
    system made over the same curve, and come back as plain bools (the
    port's own verdicts: a proof accepted, a wrong input and a moved point
    rejected, G2 over Fq2 and over Fq); no curve's pairing_check is
    replaced."""
    from _torch_port import trapdoor_groth16
    from libsnark_tpu_torch.proof_systems.groth16 import Groth16
    from libsnark_tpu_torch.relations.examples import generate_r1cs_example
    pool = chip_smoke.VerifierPool(2)
    curves = [get_curve(name) for name in ("alt_bn128", "bw6_761")]
    try:
        for curve in curves:
            cs, primary, aux = generate_r1cs_example(curve.r, 4, 2)
            vk, proof = trapdoor_groth16(curve, cs, primary, aux, seed=3)
            bad = [(primary[0] + 1) % curve.r] + primary[1:]
            moved = type(proof)(g_A=proof.g_A, g_B=proof.g_B,
                                g_C=proof.g_C + curve.G1.one())
            got = pool.verdicts(Groth16(curve, device="cpu"), [
                ("verifier_strong_IC", (vk, primary, proof)),
                ("verifier_strong_IC", (vk, bad, proof)),
                ("verifier_strong_IC", (vk, primary, moved))])
            assert got == [True, False, False]
            assert all(type(v) is bool for v in got)
    finally:
        pool.shutdown()
    assert all("pairing_check" not in c.__dict__ for c in curves)


def test_point_coords_round_trip():
    """Host points (G1, G2 over Fq2 and over Fq, infinity) and field
    elements of every tower level cross to a worker through HostPickler:
    the same points and elements after pickle.loads, and point_coords reads
    the same integers on both sides."""
    import pickle
    for name in ("alt_bn128", "bw6_761"):
        curve = get_curve(name)
        for group in (curve.G1, curve.G2):
            for P in (group.one() * 5, group.zero()):
                Q = pickle.loads(chip_smoke.host_dumps(P))
                assert Q == P and Q.group is P.group
                assert chip_smoke.point_coords(Q) == \
                    chip_smoke.point_coords(P)
    bls = get_curve("bls12_377")
    e = bls.pairing_engine.miller_loop(
        bls.pairing_engine.embed_g2(bls.G2.one() * 3),
        bls.pairing_engine.embed_g1(bls.G1.one() * 2))
    assert pickle.loads(chip_smoke.host_dumps([e, bls.Fq(7)])) == [
        e, bls.Fq(7)]


def test_device_events_read_the_raw_records():
    """chip_smoke.device_events: (name, start us, end us) of each device
    event, from the profiler's raw records; host events left out, and a
    profiler without raw records raises rather than read another source."""
    from types import SimpleNamespace as NS
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    raw = [NS(name=lambda: "k<8, 16>", start_ns=lambda: 5000,
              duration_ns=lambda: 2500, device_type=lambda: cuda),
           NS(name=lambda: "cudaLaunchKernel", start_ns=lambda: 1000,
              duration_ns=lambda: 100, device_type=lambda: cpu)]
    prof = NS(profiler=NS(kineto_results=NS(events=lambda: raw)))
    assert chip_smoke.device_events(prof) == [("k<8, 16>", 5.0, 7.5)]
    with pytest.raises(AttributeError):
        chip_smoke.device_events(NS(events=lambda: []))


def test_phase_launches_add_up_and_each_needed_kernel_must_launch():
    """phase_totals adds a path's phases; require_launched fails on a
    needed kernel with no launch and on a launch of the public dbl or
    aadd, and passes otherwise."""
    phases = {"keygen": {"mont_mul_n16": 3, "madd_win_fp_n16": 1},
              "prove": {"mont_mul_n16": 2, "bucket_reduce_fp_n16": 4}}
    total = chip_smoke.phase_totals(phases)
    assert total == {"mont_mul_n16": 5, "madd_win_fp_n16": 1,
                     "bucket_reduce_fp_n16": 4}
    chip_smoke.require_launched("ram", total, ["mont_mul_n16",
                                               "bucket_reduce_fp_n16"])
    with pytest.raises(AssertionError, match="not launched .*add_fp_n16"):
        chip_smoke.require_launched("ram", total, ["add_fp_n16"])
    with pytest.raises(AssertionError, match="public dbl / aadd .*dbl_fp"):
        chip_smoke.require_launched("ram", dict(total, dbl_fp_n16=1),
                                    ["mont_mul_n16"])
