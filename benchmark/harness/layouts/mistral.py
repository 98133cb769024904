"""The Mistral family's weights and program (dense MLP): the benchmark's
own NF4 tree (:mod:`harness.weights`) and the port's ``DecodeEngine`` over
it (:mod:`harness.model`)."""

from ..model import build_engine, read_kv  # noqa: F401
from ..weights import make_weights  # noqa: F401
