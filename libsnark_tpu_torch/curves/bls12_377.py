"""BLS12-377 curve parameters (the Clearmatics-fork headline curve).

Reference: clearmatics/libsnark adds BLS12-377/BW6-761 support (pairing
gadgets under gadgetlib1/gadgets/pairing/bw6_761_bls12_377/). Constants are
the public BLS12-377 parameters (Zexe / arkworks standard); q and r are
re-derived from the BLS x-parameter at import as a self-check.

Fr has two-adicity 47 -- NTT domains up to 2^47.
"""
from .curve import Curve

# BLS12 parameterization: r(x) = x^4 - x^2 + 1, q(x) = ((x-1)^2 r)/3 + x
X = 0x8508C00000000001  # 9586122913090633729

R = X**4 - X**2 + 1
Q = ((X - 1) ** 2 * R) // 3 + X

assert R == 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001
assert Q == 0x1AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001

# Standard generators (Zexe/arkworks)
G1_X = 81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695
G1_Y = 241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030

G2_X = (233578398248691099356572568220835526895379068987715365179118596935057653620464273615301663571204657964920925606294,
        140913150380207355837477652521042157274541796891053068589147167627541651775299824604154852141315666357241556069118)
G2_Y = (63160294768292073209381361943935198908131692476676907196754037919244929611450776219210369229519898517858833747423,
        149157405641012693445398062341192467754805999074082136895788947234480009303640899064710353187729182149407503257491)

# cofactors (standard BLS12 formulas)
G1_COFACTOR = (X - 1) ** 2 // 3
G2_COFACTOR = (X**8 - 4 * X**7 + 5 * X**6 - 4 * X**4 + 6 * X**3 - 4 * X**2 - 4 * X + 13) // 9


def build():
    return Curve(
        name="bls12_377",
        x_param=X,
        family="bls",
        q=Q,
        r=R,
        b=1,
        g1_gen=(G1_X, G1_Y),
        fq2_non_residue=Q - 5,          # u^2 = -5
        fq6_non_residue_c=(0, 1),       # xi = u
        twist_type="D",
        g2_gen=(G2_X, G2_Y),
        fr_mult_gen=22,                 # libff/arkworks bls12_377 Fr generator
        fq_mult_gen=15,
        g1_cofactor=G1_COFACTOR,
        g2_cofactor=G2_COFACTOR,
    )
