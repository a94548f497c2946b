"""Test configuration.

Runs JAX on a virtual 8-device CPU mesh so multi-device sharding paths
(mic.parallel / mic.device) are exercised without accelerators, per the
project test strategy (SURVEY.md §4, §7), with Pallas kernels in
interpret mode.  Tests marked ``gpu`` need the GPU: run them on a card
with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``; elsewhere the
``gpu_backend`` fixture skips them.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# The CPU unless the caller names a platform (the gpu-marked run).
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# The reference's corpus lives outside the repo; the committed web
# testdata holds its CT, MR and WSI tissue pixels (web/gen_testdata.py).
REFERENCE_TESTDATA = Path("/root/reference/testdata")
WEB_TESTDATA = Path(__file__).resolve().parent.parent / "web" / "testdata"


def _load_bin(name: str, rows: int, cols: int):
    px = np.fromfile(WEB_TESTDATA / name, dtype="<u2", count=rows * cols)
    return px, rows, cols, int(px.max())


@pytest.fixture(scope="session")
def mr_image():
    """MR 256x256 16-bit (the reference's MR_256_256_image.bin)."""
    return _load_bin("MR_2s.raw", 256, 256)


@pytest.fixture(scope="session")
def ct_image():
    """CT 512x512 16-bit (the reference's CT_512_512_image.bin)."""
    return _load_bin("CT_2s.raw", 512, 512)


@pytest.fixture(scope="session")
def dicom_images():
    """NEMA compsamples greyscale DICOMs present in the snapshot."""
    from mic.utils.dicom import read_dicom

    ref = REFERENCE_TESTDATA / "compsamples_refanddir" / "IMAGES" / "REF"
    if not ref.exists():
        pytest.skip("NEMA compsamples DICOMs are not in the repo")
    out = {}
    for name in ["CT1_UNC", "CT2_UNC", "MR1_UNC", "MR2_UNC", "MR3_UNC",
                 "MR4_UNC", "NM1_UNC", "XA1_UNC"]:
        p = ref / name
        if p.exists():
            try:
                img = read_dicom(str(p))
                if img.samples_per_pixel == 1:
                    out[name] = img
            except Exception:
                pass
    if not out:
        pytest.skip("no parseable DICOMs")
    return out


@pytest.fixture(scope="session")
def rgb_tissue():
    """512x384 interleaved RGB synthetic tissue (the reference's
    wsi_tissue_512x384.rgb)."""
    return np.fromfile(WEB_TESTDATA / "tissue.raw", dtype=np.uint8), 512, 384


@pytest.fixture(scope="session")
def rgb_dicom():
    """US1 RGB ultrasound DICOM (NEMA compsamples)."""
    from mic.utils.dicom import read_dicom

    p = REFERENCE_TESTDATA / "compsamples_refanddir" / "IMAGES" / "REF" / "US1_UNC"
    if not p.exists():
        pytest.skip("NEMA compsamples DICOMs are not in the repo")
    img = read_dicom(str(p))
    if img.samples_per_pixel != 3:
        pytest.skip("US1 not RGB?")
    return img


@pytest.fixture()
def gpu_backend():
    """Skips the test unless JAX runs on the GPU (the ``gpu`` marker's
    tests use it; decided here, at run time, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda on a card)")


@pytest.fixture()
def rng():
    # Function-scoped with a fixed seed: each test sees the same stream
    # regardless of execution order or new tests being added.
    return np.random.default_rng(1234)
