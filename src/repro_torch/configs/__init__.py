# Config package: base dataclasses + one module per assigned architecture
# (data copied from ``repro.configs``; imports neither jax nor repro).
