"""Shared CLI helpers: protobuf file IO (.binpb / .txtpb) and --device."""

from __future__ import annotations

from google.protobuf import text_format


def load_proto(path: str, message_cls):
    msg = message_cls()
    if path.endswith(".txtpb"):
        with open(path) as f:
            text_format.Parse(f.read(), msg)
    else:
        with open(path, "rb") as f:
            msg.ParseFromString(f.read())
    return msg


def save_proto(path: str, msg):
    if path.endswith(".txtpb"):
        with open(path, "w") as f:
            f.write(text_format.MessageToString(msg))
    else:
        with open(path, "wb") as f:
            f.write(msg.SerializeToString())


def add_device_argument(parser) -> None:
    parser.add_argument(
        "--device", default=None,
        help="torch device to compute on (default: the current CUDA card; 'cpu' for the host)",
    )
