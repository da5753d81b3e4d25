from setuptools import find_packages, setup

setup(
    name="raytracer_tpu",
    version="0.1.0",
    description=(
        "Wavefront path tracer in JAX with the capabilities of "
        "ARTurleite6/RayTracer"
    ),
    packages=find_packages(include=["raytracer_tpu*"]),
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    entry_points={
        "console_scripts": ["rt-tpu=raytracer_tpu.cli:main"],
    },
)
