"""Packaging (parity target: reference setup.py:1-254).  The reference's
CUDA extension build matrix has no TPU analogue — the Pallas kernels
compile at trace time via XLA/Mosaic — but the native data tier does:
``csrc/record_reader.c`` builds a small OPTIONAL C extension with
GIL-releasing record-store IO (the wheel stays installable without a
compiler; every caller falls back to the mmap path)."""

import os

from setuptools import Extension, find_packages, setup


def read_version():
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "unicore_tpu", "__init__.py")) as f:
        for line in f:
            if line.startswith("__version__"):
                return line.split("=")[1].strip().strip('"').strip("'")
    return "0.0.0"


setup(
    name="unicore-tpu",
    version=read_version(),
    description="TPU-native distributed training framework "
    "(jax/XLA/Pallas rebuild of the Uni-Core capability surface)",
    packages=find_packages(
        exclude=["tests", "tests.*", "examples", "examples.*"]
    ),
    # the PyTorch port compiles its CUDA sources with nvcc at first use
    package_data={"unicore_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "numpy",
        "ml_dtypes",
    ],
    extras_require={
        "data": ["lmdb", "tokenizers"],
        "test": ["pytest", "torch"],
    },
    ext_modules=[
        Extension(
            "unicore_tpu_native",
            sources=["csrc/record_reader.c"],
            optional=True,  # build failure must never block install
        ),
    ],
    entry_points={
        "console_scripts": [
            "unicore-train = unicore_tpu_cli.train:cli_main",
            "unicore-serve = unicore_tpu.serve.cli:main",
        ],
    },
)
