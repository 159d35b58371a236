"""Multi-chip sharding: device meshes and sharded Merkle tree builds.

The reference pipeline is strictly sequential (SURVEY.md section 2c); cell
sharding across devices with per-layer frontier gathers is this framework's
native scaling design, not a port.
"""

from .mesh import make_mesh, cells_axis, slots_axis
from .tree import sharded_slot_tree_layers, sharded_dataset_build
from .gl_tree import sharded_gl_dataset_build
from .proof_input import sharded_proof_input, sharded_gl_proof_input
