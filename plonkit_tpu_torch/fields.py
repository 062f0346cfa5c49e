"""BN254 field constants and host-side (python-int) field arithmetic.

Behavioral parity: bellman_ce/pairing_ce Fr & Fq (SURVEY D1a; constants cross-checked against contrib/template.sol:7-9 q_mod /
r_mod and the committed SRS/vk artifacts).

Host-side arithmetic uses plain python ints in canonical (non-Montgomery)
form; the device path in plonkit_tpu_torch/gpu/ uses 8x32-bit-limb Montgomery
vectors.  The file formats always store canonical values (bellman calls
``into_repr`` before serializing), so the host layer never needs Montgomery
form.
"""

# ---------------------------------------------------------------------------
# Curve / field constants
# ---------------------------------------------------------------------------

# BN254 (a.k.a. BN256 in matter-labs naming) scalar field modulus r
# contrib/template.sol:8
FR_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617
# BN254 base field modulus q  -- contrib/template.sol:7
FQ_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# curve: y^2 = x^3 + 3 over Fq (contrib/template.sol:9)
CURVE_B = 3

# Fr multiplicative-group structure: r - 1 = 2^28 * t
FR_TWO_ADICITY = 28
# Smallest multiplicative generator of Fr* (matches ff_derive for bellman's Bn256 Fr)
FR_GENERATOR = 7
# 2^28-th root of unity: g^((r-1)/2^28)
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (FR_MODULUS - 1) >> FR_TWO_ADICITY, FR_MODULUS)

# Fq two-adicity is 1 (q ≡ 3 mod 4)

# Non-residues k1..k3 used by the width-4 permutation argument
# (contrib/template.sol:845-853 permutation_non_residues; values confirmed
# against test/circuits/simple/vk.bin)
NON_RESIDUES = (5, 7, 10)

# snarkjs/circom little-endian prime tag found in .r1cs/.wtns headers
FR_MODULUS_LE_BYTES = FR_MODULUS.to_bytes(32, "little")


# ---------------------------------------------------------------------------
# Host scalar arithmetic (python ints, canonical form)
# ---------------------------------------------------------------------------

def fr_add(a: int, b: int) -> int:
    return (a + b) % FR_MODULUS


def fr_sub(a: int, b: int) -> int:
    return (a - b) % FR_MODULUS


def fr_mul(a: int, b: int) -> int:
    return (a * b) % FR_MODULUS


def fr_neg(a: int) -> int:
    return (-a) % FR_MODULUS


def fr_inv(a: int) -> int:
    if a % FR_MODULUS == 0:
        raise ZeroDivisionError("inverse of zero in Fr")
    return pow(a, -1, FR_MODULUS)


def fr_pow(a: int, e: int) -> int:
    return pow(a, e, FR_MODULUS)


def fq_add(a: int, b: int) -> int:
    return (a + b) % FQ_MODULUS


def fq_sub(a: int, b: int) -> int:
    return (a - b) % FQ_MODULUS


def fq_mul(a: int, b: int) -> int:
    return (a * b) % FQ_MODULUS


def fq_neg(a: int) -> int:
    return (-a) % FQ_MODULUS


def fq_inv(a: int) -> int:
    if a % FQ_MODULUS == 0:
        raise ZeroDivisionError("inverse of zero in Fq")
    return pow(a, -1, FQ_MODULUS)


def batch_inverse(values, modulus):
    """Montgomery batch inversion: one modular inverse for the whole list.

    Zero entries are passed through as zero (matching bellman's
    batch_inversion behavior of skipping zeros is NOT done here -- callers
    must not pass zeros unless they want a ZeroDivisionError)."""
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * v % modulus
    inv_all = pow(prefix[n], -1, modulus)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % modulus
        inv_all = inv_all * values[i] % modulus
    return out


def get_domain_omega(domain_size: int) -> int:
    """Primitive root of unity for a power-of-two domain of the given size.

    Matches bellman's Domain::new_for_size: omega = root_of_unity^(2^28/size).
    """
    assert domain_size & (domain_size - 1) == 0, "domain size must be a power of two"
    log2 = domain_size.bit_length() - 1
    assert log2 <= FR_TWO_ADICITY
    return pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - log2), FR_MODULUS)
