"""Node identity: an RSA keypair that signs and verifies (``Identity``
and ``new_nonce`` of ``tensorlink_tpu/p2p/crypto.py``, copied: receipts,
``runtime/ledger.py``, and the node handshake, ``p2p/node.py``, use it).

Signatures are RSA-PSS over SHA-256. node_id = sha256(DER(pubkey)) hex.

``cryptography`` is imported inside a ``try``, as in the reference. Where
it is missing, the module falls back to the reference's clearly
labelled INSECURE dev identity: node_id from random bytes, and
"signatures" are plain hashes that anyone holding the public key can
forge. The flow (sign, verify, node-id binding) stays runnable; a real
deployment installs ``cryptography``, and the fallback announces itself
with a warning. A verifier with real crypto refuses dev identities.
"""

from __future__ import annotations

import hashlib
import logging
import os
from pathlib import Path

try:
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding, rsa

    HAVE_CRYPTOGRAPHY = True
except ImportError:  # the dev fallback below
    hashes = serialization = padding = rsa = None
    HAVE_CRYPTOGRAPHY = False

_DEV_PREFIX = b"tlt-dev-identity:"  # marks fallback "public keys" on the wire


class Identity:
    def __init__(self, private_key):
        self._key = private_key
        if HAVE_CRYPTOGRAPHY:
            self.public_der = self._key.public_key().public_bytes(
                serialization.Encoding.DER,
                serialization.PublicFormat.SubjectPublicKeyInfo,
            )
        else:
            # dev fallback: the "private key" is 32 random bytes and the
            # "public key" derives from it by hashing — verify() can then
            # only check consistency, not authenticity (see sign()).
            self.public_der = _DEV_PREFIX + hashlib.sha256(
                b"pub:" + self._key
            ).digest()
        self.node_id = hashlib.sha256(self.public_der).hexdigest()

    # -- construction ---------------------------------------------------
    @classmethod
    def generate(cls) -> "Identity":
        if HAVE_CRYPTOGRAPHY:
            return cls(
                rsa.generate_private_key(public_exponent=65537, key_size=2048)
            )
        logging.getLogger("tensorlink_tpu_torch.crypto").warning(
            "cryptography not installed: using an INSECURE dev identity "
            "(signatures are forgeable); install 'cryptography' for any "
            "real deployment"
        )
        return cls(os.urandom(32))

    @classmethod
    def load_or_generate(cls, key_dir: str | os.PathLike, role: str) -> "Identity":
        """Persistent per-role identity (reference: keys/<role>/*.pem)."""
        path = Path(key_dir) / role / "private.pem"
        if path.exists():
            if HAVE_CRYPTOGRAPHY:
                raw = path.read_bytes()
                if raw.startswith(b"tlt-dev-key:"):
                    raise RuntimeError(
                        f"{path} holds an INSECURE dev identity (written "
                        "when 'cryptography' was not installed); delete it "
                        "to generate a real RSA key"
                    )
                key = serialization.load_pem_private_key(raw, None)
            else:
                raw = path.read_bytes()
                if not raw.startswith(b"tlt-dev-key:"):
                    raise RuntimeError(
                        "found an RSA key on disk but 'cryptography' is not "
                        "installed — cannot load it"
                    )
                # the announce-on-every-start contract: generate() warns
                # for fresh identities, this covers every restart after
                logging.getLogger("tensorlink_tpu_torch.crypto").warning(
                    "loaded INSECURE dev identity from %s (signatures are "
                    "forgeable); install 'cryptography' and delete the key "
                    "for any real deployment", path,
                )
                key = raw[len(b"tlt-dev-key:"):]
            return cls(key)
        ident = cls.generate()
        path.parent.mkdir(parents=True, exist_ok=True)
        if HAVE_CRYPTOGRAPHY:
            path.write_bytes(
                ident._key.private_bytes(
                    serialization.Encoding.PEM,
                    serialization.PrivateFormat.PKCS8,
                    serialization.NoEncryption(),
                )
            )
        else:
            path.write_bytes(b"tlt-dev-key:" + ident._key)
        os.chmod(path, 0o600)
        return ident

    # -- challenge ------------------------------------------------------
    def sign(self, data: bytes) -> bytes:
        if HAVE_CRYPTOGRAPHY:
            return self._key.sign(
                data,
                padding.PSS(
                    mgf=padding.MGF1(hashes.SHA256()),
                    salt_length=padding.PSS.MAX_LENGTH,
                ),
                hashes.SHA256(),
            )
        # INSECURE dev scheme: hash over (public key || data). Anyone who
        # has seen the public key can forge this — it only keeps the
        # handshake shape intact where cryptography is unavailable.
        return hashlib.sha256(self.public_der + data).digest()

    @staticmethod
    def verify(public_der: bytes, signature: bytes, data: bytes) -> bool:
        if public_der.startswith(_DEV_PREFIX):
            # a node with real crypto REFUSES forgeable dev identities —
            # the fallback only interoperates among hermetic dev nodes,
            # it can never weaken a production overlay
            if HAVE_CRYPTOGRAPHY:
                return False
            return signature == hashlib.sha256(public_der + data).digest()
        if not HAVE_CRYPTOGRAPHY:
            return False  # can't verify a real RSA peer without the lib
        try:
            pub = serialization.load_der_public_key(public_der)
            pub.verify(
                signature,
                data,
                padding.PSS(
                    mgf=padding.MGF1(hashes.SHA256()),
                    salt_length=padding.PSS.MAX_LENGTH,
                ),
                hashes.SHA256(),
            )
            return True
        except Exception:
            return False

    @staticmethod
    def node_id_for(public_der: bytes) -> str:
        return hashlib.sha256(public_der).hexdigest()



def new_nonce() -> bytes:
    return os.urandom(32)
