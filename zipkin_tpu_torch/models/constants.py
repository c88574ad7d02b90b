"""Core annotation constants.

Parity with the reference's ``zipkin-common`` Constants
(/root/reference/zipkin-common/src/main/scala/com/twitter/zipkin/Constants.scala:20-36):
the four core RPC annotations (client send/recv, server send/recv) plus the
client/server address binary-annotation keys.
"""

CLIENT_SEND = "cs"
CLIENT_RECV = "cr"
SERVER_SEND = "ss"
SERVER_RECV = "sr"

CLIENT_ADDR = "ca"
SERVER_ADDR = "sa"

CORE_CLIENT = frozenset((CLIENT_SEND, CLIENT_RECV))
CORE_SERVER = frozenset((SERVER_SEND, SERVER_RECV))
CORE_ANNOTATIONS = CORE_CLIENT | CORE_SERVER
CORE_ADDRESS = frozenset((CLIENT_ADDR, SERVER_ADDR))

# Stable small ids for core annotations in the columnar dictionary space.
# The host DictionaryEncoder reserves these so device-side queries can
# exclude/include core annotations with integer compares.
CORE_ANNOTATION_IDS = {
    CLIENT_SEND: 0,
    CLIENT_RECV: 1,
    SERVER_RECV: 2,
    SERVER_SEND: 3,
    CLIENT_ADDR: 4,
    SERVER_ADDR: 5,
}
FIRST_USER_ANNOTATION_ID = 8
