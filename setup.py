from setuptools import setup, find_packages
import io
import re

with io.open("xcontour_tpu/__init__.py", "rt", encoding="utf8") as f:
    version = re.search(r'__version__ = "(.*?)"', f.read()).group(1)

setup(
    name="xcontour_tpu",
    version=version,
    description="TPU-native contour-coordinate diagnostics (JAX/XLA/Pallas)",
    long_description=open("README.md", encoding="utf-8").read(),
    long_description_content_type="text/markdown",
    license="MIT",
    keywords="contour jax tpu pallas equivalent-latitude effective-diffusivity",
    packages=find_packages(exclude=["docs", "tests", "examples", "tools"]),
    # the PyTorch port builds its CUDA sources with nvcc at first use
    package_data={"xcontour_tpu": ["../csrc/*.cpp"],
                  "xcontour_tpu_torch": ["csrc/*.cu", "csrc/*.cpp"]},
    entry_points={
        "console_scripts": ["xcontour-tpu = xcontour_tpu.cli:main",
                            "xcontour-tpu-torch = xcontour_tpu_torch.cli:main"],
    },
    python_requires=">=3.10",
    install_requires=[
        "numpy",
        "jax",
    ],
    extras_require={
        "io": ["h5py", "scipy"],
    },
)
