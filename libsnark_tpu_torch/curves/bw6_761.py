"""BW6-761: the outer curve to BLS12-377 for one-layer proof composition.

Parameters RE-DERIVED from first principles (scripts/gen_cp6.py): the
deterministic minimal Cocks-Pinch (k=6, D=3) solution over r = q_BLS12-377
-- which is exactly the BW6-761 design point [EHG19]: 761-bit q,
E: y^2 = x^3 - 1, sextic M-twist E': y^2 = x^3 + 4, GT in Fq6.

Outer-curve scalar field == BLS12-377 base field, so a BLS12-377 Groth16
verifier is native arithmetic inside a BW6-761 circuit (reference:
gadgetlib1/gadgets/pairing/bw6_761_bls12_377/).
"""
from .w6_curve import W6Curve

Q = int(
    "0x122e824fb83ce0ad187c94004faff3eb926186a81d14688528275ef8087be417"
    "07ba638e584e91903cebaff25b423048689c8ed12f9fd9071dcd3dc73ebff2e98a"
    "116c25667a8f8160cf8aeeaf0a437e6913e6870000082f49d00000000008b", 16)

# r = q of BLS12-377
X_BLS = 0x8508C00000000001
R = ((X_BLS - 1) ** 2 * (X_BLS**4 - X_BLS**2 + 1)) // 3 + X_BLS

TRACE = int(
    "0x15d8f58f3501dbec1ab2f9cb6145aeecb55fc0d440cb48f058490fb409869401"
    "70b5d44300000007467a800000000010", 16)
Y_CM = int(
    "0xf200c76d5ed9840fb4f18c5c607e562b66d395f6f661e41588824c567582c00e"
    "671a4a9e0000004d9a700000000000a", 16)

_N_G1 = Q + 1 - TRACE
_N_G2 = Q + 1 - (TRACE + 3 * Y_CM) // 2
assert _N_G1 % R == 0 and _N_G2 % R == 0
G1_COFACTOR = _N_G1 // R
G2_COFACTOR = _N_G2 // R

# E: y^2 = x^3 - 1;  twist coefficient 4 = b * xi with xi = -4
B = Q - 1
XI = Q - 4


def build():
    return W6Curve(
        name="bw6_761",
        q=Q,
        r=R,
        trace=TRACE,
        b=B,
        xi=XI,
        g1_cofactor=G1_COFACTOR,
        g2_cofactor=G2_COFACTOR,
        fr_mult_gen=15,     # multiplicative generator of Fr = Fq(BLS12-377)
        fq_mult_gen=2,
        twist_type="M",
    )
