"""Succinct finality certificates (TECHNICAL.md "Finality certificates").

Counterpart of ``at2_node_tpu/finality/__init__.py``.

Turns the fleet-internal audit beacons (obs/audit.py) into signed,
externally-portable evidence: every node co-signs the canonical
(epoch, watermark digest, account-range lanes, directory digest) tuple
at each ``audit_every`` commit frontier (wire kind 16,
broadcast/messages.CertSig); the :class:`~.certs.CertAssembler` folds
2f+1 co-signatures into a quorum :class:`~.certs.Certificate` behind
the pluggable :mod:`~.scheme` seam; :mod:`~.light` verifies one with
nothing but a handful of known member public keys — no node state, no
gRPC stream, no trust in the serving node.
"""

from .certs import CertAssembler, Certificate  # noqa: F401
from .light import LightVerifier, verify_chain  # noqa: F401
from .scheme import AttestationScheme, get_scheme, register_scheme  # noqa: F401
