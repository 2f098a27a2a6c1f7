"""Quadruped MPC framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
Magicyw/Quadruped-PyMPC-TAMOLS: sampling MPC (random-sampling / MPPI / CEM-MPPI over
tens of thousands of SRB rollouts), gradient MPC (RTI-SQP with a batched interior-point
QP), TAMOLS terrain-aware foothold planning, whole-body control (gait timing, foothold
reference, swing trajectories, IK, torque mapping), simulation harnesses, and
multi-device scaling over jax.sharding meshes.
"""
from .config import (
    Config,
    CostWeights,
    GaitParams,
    GaitType,
    GradientParams,
    MPCParams,
    RobotParams,
    SamplingParams,
    SimParams,
    TamolsParams,
    make_config,
    replace_config,
    validate_config,
    ROBOTS,
    GAITS,
    LEGS,
)
from .utils.legs import Legs

__version__ = "0.1.0"
