"""Engine configuration (port of emloco_tpu/physics/types.py).

Same fields and defaults as the JAX EngineConfig, and every branch of the
JAX engine is ported: the TGS step (the default) and the fully re-assembled
implicit substeps (`tgs_step=False` or `n_substeps=1`), each with the
block-arrow or the dense solver and the env-last or batch-major layout; each
LHS assembly (the single-operand √w Gram, the two-operand Gram and the
`gram_kernel` Gram); ground contacts through the capsule end-spheres or the
mesh colliders (`mesh_contacts`), looked up in the global corner texture or a
per-env window of it (`terrain_patch`); and the self-contact capsule pairs
(`self_contact`).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Solver budget: control dt 1/30 s, 2 implicit substeps."""

    control_dt: float = 1.0 / 30.0
    n_substeps: int = 2
    gravity: float = -9.81
    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    linear_damping: float = 0.05
    angular_damping: float = 0.05
    contact_stiffness: float = 240000.0
    contact_damping: float = 2000.0
    friction_vel_ref: float = 0.05
    max_friction_damping: float = 4000.0
    self_contact: bool = False
    mesh_contacts: bool = False
    max_depenetration: float = 0.02
    max_linear_velocity: float = 50.0
    max_angular_velocity: float = 60.0
    blocked_solver: bool = True
    tgs_step: bool = True
    # Jacobian row tensors stored in bfloat16 (the LHS/RHS and the solve
    # stay float32), as in the JAX engine
    rows_bf16: bool = True
    terrain_patch: int = 0
    batch_major_solver: bool = False
    gram_kernel: bool = False
    sqrt_gram: bool = True

    @property
    def substep_dt(self) -> float:
        return self.control_dt / self.n_substeps
