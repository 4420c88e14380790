"""The distributed planes — counterpart of ``dla_tpu/parallel`` — on meshes
whose members share one device: the block-cyclic factorization, its solve
and serving planes on a p×q :class:`MemberMesh`, and the ring planes on a
flat :class:`FlatMesh`. Names as in the JAX package's ``__init__``; its TPU
projections (``CHIPS``, ``crossover_n``, ``project``, ``single_chip_rate``,
``project_serving``) are not ported.
"""

from dla_tpu_torch.parallel.block_cyclic import (  # noqa: F401
    BlockCyclicLayout,
    MemberMesh,
    from_dense,
    generate_spd_block_cyclic,
    make_mesh,
    to_dense,
)
from dla_tpu_torch.parallel.column_cyclic import (  # noqa: F401
    FlatMesh,
    from_dense_cols,
    make_flat_mesh,
    potrf_column_cyclic_ring,
    to_dense_cols,
)
from dla_tpu_torch.parallel.model import (  # noqa: F401
    packed_cyclic_accounting,
    packed_resident_bytes,
)
from dla_tpu_torch.parallel.packed_cyclic import (  # noqa: F401
    pack_cols_packed,
    potrf_packed_cyclic,
    potrf_packed_cyclic_df64,
    resident_elems,
    unpack_cols_packed,
)
from dla_tpu_torch.parallel.potrf_dist import (  # noqa: F401
    flop_accounting,
    flop_accounting_super,
    potrf_block_cyclic,
)
from dla_tpu_torch.parallel.serving import (  # noqa: F401
    make_serving_mesh,
    serving_comm_elems,
    sharded_apply,
    solve_inverse_sharded,
)
from dla_tpu_torch.parallel.solve_dist import potrs_block_cyclic  # noqa: F401
