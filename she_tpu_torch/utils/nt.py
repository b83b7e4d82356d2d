"""Host-side number theory utilities (exact, Python big ints).

Semantics mirror the reference library's scalar layer so that generated
primes, roots of unity and derived tables are bit-identical:

* Miller-Rabin primality with the fixed 12-base witness set
  (reference: Sources/HomomorphicEncryption/Scalar.swift:160-201).
* NTT-friendly prime search order (Scalar.swift:113-154).
* Minimal primitive 2N-th root of unity selection
  (Sources/HomomorphicEncryption/PolyRq/PolyRq+Ntt.swift:24-105).

All of this runs once per parameter set on the host; the results ship to
device kernels as constant tables.
"""

from __future__ import annotations

MILLER_RABIN_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers 64-bit scalars)."""
    if n <= 1:
        return False
    for base in MILLER_RABIN_BASES:
        if n == base:
            return True
        if n % base == 0:
            return False
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for base in MILLER_RABIN_BASES:
        x = pow(base, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def is_ntt_modulus(q: int, degree: int) -> bool:
    """q prime is a valid NTT modulus for a power-of-two degree.

    Reference: PolyRq+Ntt.swift:24-27 (q % 2N == 1 and q != 1).
    """
    return is_power_of_two(degree) and q % (2 * degree) == 1 and q != 1


def generate_primes(
    significant_bit_counts: list[int],
    preferring_small: bool,
    ntt_degree: int = 1,
    bit_width: int = 64,
) -> list[int]:
    """NTT-friendly primes, one per requested bit count.

    Search order matches the reference exactly (Scalar.swift:113-154):
    candidates walk the range [2^(b-1), 2^b) in steps of 2*ntt_degree
    starting from lower+1 (small) or upper-2N+1 (large), skipping primes
    already chosen.
    """
    assert is_power_of_two(ntt_degree)
    primes: list[int] = []
    for b in significant_bit_counts:
        assert b <= bit_width
        upper = (1 << bit_width) - 1 if b == bit_width else (1 << b)
        lower = 1 << (b - 1)
        step = 2 * ntt_degree
        candidate = lower + 1 if preferring_small else (upper - step) + 1
        found = False
        while lower <= candidate < upper:
            if (
                candidate not in primes
                and is_prime(candidate)
                and is_ntt_modulus(candidate, ntt_degree)
            ):
                primes.append(candidate)
                found = True
                break
            candidate += step if preferring_small else -step
        if not found:
            raise ValueError(
                f"not enough primes for bit counts {significant_bit_counts} "
                f"(nttDegree={ntt_degree}, preferringSmall={preferring_small})"
            )
    return primes


def is_primitive_root_of_unity(root: int, degree: int, modulus: int) -> bool:
    """For power-of-two degree: root^(degree/2) == -1 mod q."""
    assert is_power_of_two(degree)
    return pow(root, degree // 2, modulus) == modulus - 1


def _any_primitive_root_of_unity(modulus: int, degree: int) -> int | None:
    """Some primitive degree-th root of unity mod prime modulus.

    The reference searches randomly (PolyRq+Ntt.swift:45-79); any primitive
    root works because the caller minimises over the whole coset. We search
    g = 2, 3, ... deterministically.
    """
    lam = modulus - 1
    if lam % degree != 0:
        return None
    if degree == 1:
        return 1
    for g in range(2, modulus):
        root = pow(g, lam // degree, modulus)
        if is_primitive_root_of_unity(root, degree, modulus):
            return root
        if g > 1000:  # prime => a generator exists among small values
            break
    return None


def min_primitive_root_of_unity(modulus: int, degree: int) -> int | None:
    """Smallest primitive degree-th root of unity mod prime modulus.

    Matches reference minPrimitiveRootOfUnity (PolyRq+Ntt.swift:87-105):
    scan g, g^3, g^5, ... (odd powers are exactly the primitive roots for
    power-of-two degree) and take the minimum.
    """
    g = _any_primitive_root_of_unity(modulus, degree)
    if g is None:
        return None
    smallest = g
    current = g
    g2 = (g * g) % modulus
    for _ in range(degree // 2):
        if current < smallest:
            smallest = current
        current = (current * g2) % modulus
    return smallest


def inverse_mod(x: int, modulus: int) -> int:
    """x^-1 mod modulus; raises if not invertible."""
    return pow(x, -1, modulus)


def reverse_bits(x: int, bit_count: int) -> int:
    return int(format(x & ((1 << bit_count) - 1), f"0{bit_count}b")[::-1], 2) if bit_count else 0


def log2_exact(n: int) -> int:
    assert is_power_of_two(n), n
    return n.bit_length() - 1


def next_power_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()
