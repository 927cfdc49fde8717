from .blob import Blob, typed_blob  # noqa: F401
from .message import HEADER_SIZE, Message, MsgType  # noqa: F401
from .node import Node, Role, is_server, is_worker, role_from_string  # noqa: F401
