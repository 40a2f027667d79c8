"""Every transform's apply is bitwise what it was before its constants
became capture-safe.

A CUDA graph cannot capture a host→device copy, so the constants an
apply makes (the WHT's Hadamard factors and scale, FJLT's and SJLT's
scales, WZT's exponent, NURST's cdf, the Halton bases, every
``core.random._const``) are now made once per (value, dtype, device)
and kept (``sketch/fut.py``, ``fjlt.py``, ``hash.py``, ``sampling.py``,
``quasi.py``, ``core/quasirand.py``, ``core/random.py``).  The values
must not move: each case's output, on fixed seeds in f32 and bf16, is
held against the SHA-256 (first 16 hex digits) of the bytes the port
gave before the change.  Cases: every registered transform at N = 300
→ S = 40 (``NURST`` with probabilities 1..2, ``SJLT`` with nnz = 2) in
both dims at 5 and 20 columns (the hash sketches' scatter and one-hot
routes), the WHT at 2^9 and 2^16 (several factors), the DCT, and the
slice kernels at a host start and at a device start (in and past the
domain), their windows drawn.  The QRFTs and the QRLT take no bf16 input on the CPU.
The FJLT cases pin its WHT route (``SKYLARK_NO_SRHT_GEMM=1``), the route
they were taken on; at these shapes its gate now sends the default apply
to the subsampled-Hadamard GEMM, which ``tests/test_torch_matmul_routes.py``
holds.
"""

import hashlib

import numpy as np
import pytest
import torch

import libskylark_tpu_torch as T
from libskylark_tpu_torch.sketch import fut
from libskylark_tpu_torch.sketch.hash import HashSketch

N, S, SEED = 300, 40, 77
PARAMS = {"NURST": {"probs": np.linspace(1.0, 2.0, N)}, "SJLT": {"nnz": 2}}

APPLY = {
    "CT|bfloat16|columnwise|300x20": "8993f526db669307",
    "CT|bfloat16|columnwise|300x5": "b2536e0941247cb9",
    "CT|bfloat16|rowwise|20x300": "30ad45cbcb5d931f",
    "CT|bfloat16|rowwise|5x300": "b5cb45499a8aa3b7",
    "CT|float32|columnwise|300x20": "b2a57bb4bb401874",
    "CT|float32|columnwise|300x5": "5faa69b204b89e6c",
    "CT|float32|rowwise|20x300": "892fd56a8805b466",
    "CT|float32|rowwise|5x300": "b2974e07008a0729",
    "CWT|bfloat16|columnwise|300x20": "de1b60ace6358cfa",
    "CWT|bfloat16|columnwise|300x5": "4aff5d2ecd31887c",
    "CWT|bfloat16|rowwise|20x300": "1c16c1c99c04e919",
    "CWT|bfloat16|rowwise|5x300": "617cc23fab2d69c7",
    "CWT|float32|columnwise|300x20": "1c04ff6447ce6122",
    "CWT|float32|columnwise|300x5": "220a80db8d2a7905",
    "CWT|float32|rowwise|20x300": "dc471b6f8c2b6025",
    "CWT|float32|rowwise|5x300": "8bf503cd2c7ce88c",
    "ExpSemigroupQRLT|float32|columnwise|300x20": "60b737b4b1a4204f",
    "ExpSemigroupQRLT|float32|columnwise|300x5": "00c03983f5c70938",
    "ExpSemigroupQRLT|float32|rowwise|20x300": "8ab0ae157721b630",
    "ExpSemigroupQRLT|float32|rowwise|5x300": "aaf2047b9784e0c5",
    "ExpSemigroupRLT|bfloat16|columnwise|300x20": "22bcf05b2404aa42",
    "ExpSemigroupRLT|bfloat16|columnwise|300x5": "67c64c90e0f393a7",
    "ExpSemigroupRLT|bfloat16|rowwise|20x300": "3f8b5ba6e8d024f2",
    "ExpSemigroupRLT|bfloat16|rowwise|5x300": "f1416ebe424cfb2a",
    "ExpSemigroupRLT|float32|columnwise|300x20": "2ac9bb1680687434",
    "ExpSemigroupRLT|float32|columnwise|300x5": "5a707679291d8371",
    "ExpSemigroupRLT|float32|rowwise|20x300": "064c8e5929e1167f",
    "ExpSemigroupRLT|float32|rowwise|5x300": "f94c8e0bce344e33",
    "FJLT|bfloat16|columnwise|300x20": "759ac0f6591b168c",
    "FJLT|bfloat16|columnwise|300x5": "a7f553d9186b49fd",
    "FJLT|bfloat16|rowwise|20x300": "0fb35b7a6d27164c",
    "FJLT|bfloat16|rowwise|5x300": "d252a145ffbe7878",
    "FJLT|float32|columnwise|300x20": "3827bce2e8b51d73",
    "FJLT|float32|columnwise|300x5": "6d1bcbef44339691",
    "FJLT|float32|rowwise|20x300": "fdafa88fe2e9016d",
    "FJLT|float32|rowwise|5x300": "930f96f59f696924",
    "FastGaussianRFT|bfloat16|columnwise|300x20": "e058371dc79881ca",
    "FastGaussianRFT|bfloat16|columnwise|300x5": "f9cf3d9f6fa36d2f",
    "FastGaussianRFT|bfloat16|rowwise|20x300": "690392903beef92d",
    "FastGaussianRFT|bfloat16|rowwise|5x300": "45519a3f3cc1b8b4",
    "FastGaussianRFT|float32|columnwise|300x20": "23e603dcfbb75b25",
    "FastGaussianRFT|float32|columnwise|300x5": "74a381a403331da4",
    "FastGaussianRFT|float32|rowwise|20x300": "befee64ea24898f2",
    "FastGaussianRFT|float32|rowwise|5x300": "64564a9d4c9ddea3",
    "FastMaternRFT|bfloat16|columnwise|300x20": "b24caad591aa49e6",
    "FastMaternRFT|bfloat16|columnwise|300x5": "04d20162ac7e2808",
    "FastMaternRFT|bfloat16|rowwise|20x300": "a68ae36f2c023d7c",
    "FastMaternRFT|bfloat16|rowwise|5x300": "908e1d64da535b5e",
    "FastMaternRFT|float32|columnwise|300x20": "a1d278c48a275182",
    "FastMaternRFT|float32|columnwise|300x5": "3ef9eaa2ba7adbd2",
    "FastMaternRFT|float32|rowwise|20x300": "4644d6db9d271abf",
    "FastMaternRFT|float32|rowwise|5x300": "2533af3bdec3b182",
    "GaussianQRFT|float32|columnwise|300x20": "2c9142e763bf0d6e",
    "GaussianQRFT|float32|columnwise|300x5": "08088c6b7d5e49ec",
    "GaussianQRFT|float32|rowwise|20x300": "b3c4e96eb6150b5b",
    "GaussianQRFT|float32|rowwise|5x300": "8019b176fab3a3c7",
    "GaussianRFT|bfloat16|columnwise|300x20": "08a4615ebb0c92c8",
    "GaussianRFT|bfloat16|columnwise|300x5": "b106317be30c43b0",
    "GaussianRFT|bfloat16|rowwise|20x300": "01fdd0011a1f0fa8",
    "GaussianRFT|bfloat16|rowwise|5x300": "005a3d587ac51d35",
    "GaussianRFT|float32|columnwise|300x20": "ecaf2ef8f56ffb9b",
    "GaussianRFT|float32|columnwise|300x5": "cbad55667c5dc583",
    "GaussianRFT|float32|rowwise|20x300": "2f3813a7aacf3072",
    "GaussianRFT|float32|rowwise|5x300": "277f1cd660c31a0c",
    "JLT|bfloat16|columnwise|300x20": "e39c8dea555cb0ef",
    "JLT|bfloat16|columnwise|300x5": "0a5543b684d1b8e9",
    "JLT|bfloat16|rowwise|20x300": "819166bb861f8f74",
    "JLT|bfloat16|rowwise|5x300": "5a105e518526af10",
    "JLT|float32|columnwise|300x20": "ece9ec8ea92e02cd",
    "JLT|float32|columnwise|300x5": "8c8590b87f4fccd2",
    "JLT|float32|rowwise|20x300": "a29d438990446177",
    "JLT|float32|rowwise|5x300": "6f03f006ce6e4065",
    "LaplacianQRFT|bfloat16|columnwise|300x20": "9d0c21a71d313d8f",
    "LaplacianQRFT|bfloat16|columnwise|300x5": "61b6a8ff8a3ff16b",
    "LaplacianQRFT|bfloat16|rowwise|20x300": "5dc3841f21a033f9",
    "LaplacianQRFT|bfloat16|rowwise|5x300": "cff803e81a0d926c",
    "LaplacianQRFT|float32|columnwise|300x20": "d197bd349d873536",
    "LaplacianQRFT|float32|columnwise|300x5": "9299e09c6f11429c",
    "LaplacianQRFT|float32|rowwise|20x300": "657930de7d512b16",
    "LaplacianQRFT|float32|rowwise|5x300": "d4b3cc844afcfa1b",
    "LaplacianRFT|bfloat16|columnwise|300x20": "3f2bd727f094c17e",
    "LaplacianRFT|bfloat16|columnwise|300x5": "178632466d4835cd",
    "LaplacianRFT|bfloat16|rowwise|20x300": "b7bbfa1071e671ae",
    "LaplacianRFT|bfloat16|rowwise|5x300": "b3d9cb1b998fa84c",
    "LaplacianRFT|float32|columnwise|300x20": "b82556f700567473",
    "LaplacianRFT|float32|columnwise|300x5": "281a9d1b6b0186fa",
    "LaplacianRFT|float32|rowwise|20x300": "d45e75b7f8eb2685",
    "LaplacianRFT|float32|rowwise|5x300": "a5e6d94d32b0c196",
    "MMT|bfloat16|columnwise|300x20": "9bec64c29a4e1fae",
    "MMT|bfloat16|columnwise|300x5": "64721c7605d479ae",
    "MMT|bfloat16|rowwise|20x300": "44557935abdf42c3",
    "MMT|bfloat16|rowwise|5x300": "bf50cba071f92cee",
    "MMT|float32|columnwise|300x20": "547b38c8c573dc29",
    "MMT|float32|columnwise|300x5": "6749dce9d7b5e22a",
    "MMT|float32|rowwise|20x300": "39396ccbfbe3e2a1",
    "MMT|float32|rowwise|5x300": "b41a4fe8faadec29",
    "MaternRFT|bfloat16|columnwise|300x20": "d225cf55e3653001",
    "MaternRFT|bfloat16|columnwise|300x5": "1146a980b489d1a6",
    "MaternRFT|bfloat16|rowwise|20x300": "f84d6f5668a0abd0",
    "MaternRFT|bfloat16|rowwise|5x300": "bf2718b9e2ed16f0",
    "MaternRFT|float32|columnwise|300x20": "fbfedb4bc08b2f7b",
    "MaternRFT|float32|columnwise|300x5": "6c6ed521e4379a03",
    "MaternRFT|float32|rowwise|20x300": "427c3af496900405",
    "MaternRFT|float32|rowwise|5x300": "548462408a681002",
    "NURST|bfloat16|columnwise|300x20": "62d48a36526c8d68",
    "NURST|bfloat16|columnwise|300x5": "7e82cac08233b2e7",
    "NURST|bfloat16|rowwise|20x300": "9aec12c0f4e14440",
    "NURST|bfloat16|rowwise|5x300": "23749560c9413567",
    "NURST|float32|columnwise|300x20": "c5feeb2c1d731577",
    "NURST|float32|columnwise|300x5": "0bc2d4121fa2a2d0",
    "NURST|float32|rowwise|20x300": "69f3395cf23a91a7",
    "NURST|float32|rowwise|5x300": "3598d88fb0f73029",
    "PPT|bfloat16|columnwise|300x20": "1f9cbe17a5982c52",
    "PPT|bfloat16|columnwise|300x5": "a61d83488b3ffa92",
    "PPT|bfloat16|rowwise|20x300": "90021e1b9088a085",
    "PPT|bfloat16|rowwise|5x300": "4f1ec7d2190e0e08",
    "PPT|float32|columnwise|300x20": "aac98dae83283bef",
    "PPT|float32|columnwise|300x5": "d03c5a25bceab0e0",
    "PPT|float32|rowwise|20x300": "6a75678d342573be",
    "PPT|float32|rowwise|5x300": "ea13a39ac9615f77",
    "QJLT|bfloat16|columnwise|300x20": "711fdf7f2e4550b0",
    "QJLT|bfloat16|columnwise|300x5": "6311082ffe0617ac",
    "QJLT|bfloat16|rowwise|20x300": "6d97aee47cf2cbc7",
    "QJLT|bfloat16|rowwise|5x300": "acd13b14425740c6",
    "QJLT|float32|columnwise|300x20": "802af51f86b8e223",
    "QJLT|float32|columnwise|300x5": "a145dd4dc790cfab",
    "QJLT|float32|rowwise|20x300": "3a1cd797b8f871ea",
    "QJLT|float32|rowwise|5x300": "497be1f3b02d3a34",
    "SJLT|bfloat16|columnwise|300x20": "2481aa0cd5559027",
    "SJLT|bfloat16|columnwise|300x5": "11123444ac5890f6",
    "SJLT|bfloat16|rowwise|20x300": "314c539676e63c5a",
    "SJLT|bfloat16|rowwise|5x300": "0a056a3a7346a4ac",
    "SJLT|float32|columnwise|300x20": "6f6e0b9cfb7f1ad8",
    "SJLT|float32|columnwise|300x5": "d6d8115b91929019",
    "SJLT|float32|rowwise|20x300": "52dac75c87fa16f7",
    "SJLT|float32|rowwise|5x300": "908453894a2cff65",
    "UST|bfloat16|columnwise|300x20": "6fb25f80ba7a484f",
    "UST|bfloat16|columnwise|300x5": "cbec22c47bc63bf0",
    "UST|bfloat16|rowwise|20x300": "86596053ed255159",
    "UST|bfloat16|rowwise|5x300": "49019f08051eaaf3",
    "UST|float32|columnwise|300x20": "53a718b2a6cc8eaf",
    "UST|float32|columnwise|300x5": "cc45fd2f63035dd3",
    "UST|float32|rowwise|20x300": "dc2d1702b4b24852",
    "UST|float32|rowwise|5x300": "fd915a896e2df180",
    "WZT|bfloat16|columnwise|300x20": "63c64ceb71ab8fba",
    "WZT|bfloat16|columnwise|300x5": "c0a4688bef6fcb67",
    "WZT|bfloat16|rowwise|20x300": "a988849b6dfc3b5a",
    "WZT|bfloat16|rowwise|5x300": "5b7f12df5e9fec03",
    "WZT|float32|columnwise|300x20": "e769e5c99b8216f2",
    "WZT|float32|columnwise|300x5": "e2fe58a049836ee2",
    "WZT|float32|rowwise|20x300": "f59dd26723b42564",
    "WZT|float32|rowwise|5x300": "9275a237769806cf",
}

OTHER = {
    "dct|512": "e8742628083d6c74",
    "dct|65536": "538776b512bfd241",
    "slice|CWT|40": "d2945610aa596099",
    "slice|CWT|tensor280": "8ac41406f7aac2c7",
    "slice|CWT|tensor40": "d2945610aa596099",
    "slice|GaussianRFT|40": "c26e6271698479d1",
    "slice|GaussianRFT|tensor280": "7848ee07661ce977",
    "slice|GaussianRFT|tensor40": "c26e6271698479d1",
    "slice|JLT|40": "579f769719ed7aab",
    "slice|JLT|tensor280": "7961bc12591b0505",
    "slice|JLT|tensor40": "579f769719ed7aab",
    "slice|MMT|40": "4ed743021ed9d386",
    "slice|MMT|tensor280": "eb58ac9b3b45bbc9",
    "slice|MMT|tensor40": "4ed743021ed9d386",
    "slice|SJLT|40": "add45b69a4047fe8",
    "slice|SJLT|tensor280": "53179c5009510d1a",
    "slice|SJLT|tensor40": "add45b69a4047fe8",
    "slice|WZT|40": "c1d93a0354549ebe",
    "slice|WZT|tensor280": "e4cd7760985c160a",
    "slice|WZT|tensor40": "c1d93a0354549ebe",
    "wht|torch.bfloat16|512": "ddacf6f00efb4632",
    "wht|torch.bfloat16|65536": "8b299dfedf1283eb",
    "wht|torch.float32|512": "af8e16a6511aa716",
    "wht|torch.float32|65536": "66d3ac6cda886045",
}


def _make(stype):
    return T.sketch.create_sketch(stype, N, S, T.SketchContext(seed=SEED), **PARAMS.get(stype, {}))


def _digest(t):
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("case", sorted(APPLY))
def test_apply_is_bitwise_what_it_was(case, monkeypatch):
    stype, dtype, dim, shape = case.split("|")
    if stype == "FJLT":
        monkeypatch.setenv("SKYLARK_NO_SRHT_GEMM", "1")
    rows, cols = (int(v) for v in shape.split("x"))
    seed = rows * 1000 + cols + (dim == "rowwise")
    A = torch.from_numpy(np.random.default_rng(seed).standard_normal((rows, cols))
                         .astype(np.float32)).to(getattr(torch, dtype))
    assert _digest(_make(stype).apply(A, dim)) == APPLY[case]


@pytest.mark.parametrize("case", sorted(OTHER))
def test_transforms_and_slices_are_bitwise_what_they_were(case, monkeypatch):
    # The slice cases draw their windows (the path whose constants moved):
    # a host start would cut its window from the memoized whole arrays,
    # and on the CPU WZT's vectorized pow may round a window and the whole
    # an ulp apart.
    monkeypatch.setattr(HashSketch, "_SLICE_MEMO_LIMIT", 0)
    kind, *rest = case.split("|")
    if kind in ("wht", "dct"):
        n = int(rest[-1])
        x = torch.from_numpy(np.random.default_rng(n).standard_normal((n, 3)).astype(np.float32))
        if kind == "wht":
            out = fut.wht(x.to(getattr(torch, rest[0].removeprefix("torch."))), 0)
        else:
            out = fut.dct(x, 0)
    else:
        stype, start = rest
        blk = torch.from_numpy(np.random.default_rng(9).standard_normal((64, 5))
                               .astype(np.float32))
        at = torch.tensor(int(start[6:])) if start.startswith("tensor") else int(start)
        out = _make(stype).apply_slice_kernel(blk, at)
    assert _digest(out) == OTHER[case]


def test_constants_are_made_once_and_kept():
    from libskylark_tpu_torch.core.quasirand import primes, primes_on
    from libskylark_tpu_torch.core.random import _const

    c = _const(0.1, torch.bfloat16, "cpu")
    assert c is _const(0.1, torch.bfloat16, "cpu") and c.dtype == torch.bfloat16
    assert _const(-0.0, torch.float32) is not _const(0.0, torch.float32)
    assert _const(1, torch.float32) is not _const(1.0, torch.float32)
    assert float(c) == float(torch.tensor(0.1, dtype=torch.bfloat16))
    assert fut._hadamard_on(3, torch.float32, "cpu") is fut._hadamard_on(3, torch.float32, "cpu")
    p = primes_on(50, "cpu")
    assert p is primes_on(50, "cpu") and np.array_equal(p.numpy(), primes(50))
    S = _make("NURST")
    assert S._cdf("cpu") is S._cdf("cpu")
