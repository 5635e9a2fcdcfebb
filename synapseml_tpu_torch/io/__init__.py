"""IO of the PyTorch port: HTTP client stages, binary/image file formats,
the PowerBI sink, port forwarding and the out-of-core column stores
(reference: core/.../io/)."""

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
from .powerbi import PowerBIResponseError, PowerBIWriter

__all__ = [
    "HTTPClient", "HTTPRequestData", "HTTPResponseData", "HTTPTransformer",
    "CustomInputParser", "CustomOutputParser", "JSONInputParser",
    "JSONOutputParser", "StringOutputParser", "SimpleHTTPTransformer",
    "BinaryFileReader", "read_binary_files", "decode_image", "read_images",
    "ChunkedColumnSource", "SparseChunkedSource", "csv_to_colstore",
    "dense_to_csr", "write_csr", "write_matrix",
    "PowerBIWriter", "PowerBIResponseError",
    "ForwardSession", "TcpRelay", "forward_port_to_remote",
]
