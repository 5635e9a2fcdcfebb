"""IO of the PyTorch port: HTTP client stages, binary/image file formats,
port forwarding and the out-of-core column stores (reference:
core/.../io/).  The PowerBI sink is queued with the services (ROADMAP
A9)."""

from .http import (HTTPClient, HTTPRequestData, HTTPResponseData,
                   CustomInputParser, CustomOutputParser,
                   HTTPTransformer, JSONInputParser, JSONOutputParser,
                   StringOutputParser,
                   SimpleHTTPTransformer)
from .binary import BinaryFileReader, read_binary_files
from .colstore import (ChunkedColumnSource, SparseChunkedSource,
                       csv_to_colstore, dense_to_csr, write_csr,
                       write_matrix)
from .image import decode_image, read_images
from .port_forward import (ForwardSession, TcpRelay,
                           forward_port_to_remote)

__all__ = [
    "HTTPClient", "HTTPRequestData", "HTTPResponseData", "HTTPTransformer",
    "CustomInputParser", "CustomOutputParser", "JSONInputParser",
    "JSONOutputParser", "StringOutputParser", "SimpleHTTPTransformer",
    "BinaryFileReader", "read_binary_files", "decode_image", "read_images",
    "ChunkedColumnSource", "SparseChunkedSource", "csv_to_colstore",
    "dense_to_csr", "write_csr", "write_matrix",
    "ForwardSession", "TcpRelay", "forward_port_to_remote",
]
