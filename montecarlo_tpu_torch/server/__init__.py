"""Host TCP/JSON layer: the reference's wire protocol over the port's table
engine (``montecarlo_tpu/server`` on ``montecarlo_tpu_torch``).

Preserves the reference server's observable behavior (``server.clj``):
port 10000, ``\\r\\n``-delimited UTF-8 JSON, commands dispatched on ``type``
(``new_room``/``join_room``/``play``/``hand``/``whoami`` — the code's
spellings, not the README's ``hand?``/``whoami?``), its exact status codes
and error strings (including the "postive" typo), gensym-style player ids,
and the message flow (hole cards then board broadcast; only in-hand players
receive board updates; hand end silently rolls into the next deal).
"""

from montecarlo_tpu_torch.server.host import Registry, Room  # noqa: F401
from montecarlo_tpu_torch.server.tcp import serve, start_server  # noqa: F401
