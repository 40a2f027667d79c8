"""Dataset IO of the port (port of ``libskylark_tpu/io``; ≙ reference
``ml/io.hpp``, ``utility/io/libsvm_io.hpp``; byte-source seam ≙ the HDFS
reader variants at ``libsvm_io.hpp:1495-1638``).

Host-side readers: dense data comes back as numpy arrays and sparse data
as uncoalesced CPU ``torch.sparse_coo_tensor``s in file order; the caller
moves them to the card.  LIBSVM parses through the port's native C core
(``native``) when it builds."""

from .arclist import arc_list_source, scan_arc_list, stream_arc_list
from .hdf5 import read_hdf5, stream_hdf5, write_hdf5
from .libsvm import read_libsvm, scan_libsvm_dims, stream_libsvm, write_libsvm
from .source import (
    ByteSource,
    FsspecSource,
    LocalSource,
    MemorySource,
    open_source,
    register_scheme,
)

__all__ = [
    "read_libsvm",
    "write_libsvm",
    "stream_libsvm",
    "scan_libsvm_dims",
    "read_hdf5",
    "write_hdf5",
    "stream_hdf5",
    "scan_arc_list",
    "stream_arc_list",
    "arc_list_source",
    "ByteSource",
    "LocalSource",
    "MemorySource",
    "FsspecSource",
    "open_source",
    "register_scheme",
]
