"""The flat-mesh ring planes — counterpart of ``dla_tpu/parallel``, on a mesh
of D members that share one device (the block-cyclic, solve and serving
planes are still to come). Names as in the JAX package's ``__init__``."""

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
