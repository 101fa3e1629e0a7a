"""NAT traversal: UPnP IGD port mapping + upward port scan.

The reference maps its listen port through the home router with miniupnpc
and scans upward from BASE_PORT when a port is taken (reference
src/p2p/smart_node.py:787-816,949-967 — `init_upnp`, port scan loop). This
is what makes the BOINC-style deployment work for peers behind consumer
NATs. Same capability here with zero dependencies: SSDP discovery over UDP,
the IGD device description fetched and parsed with stdlib XML, and the
WANIPConnection SOAP actions issued directly.

Everything is blocking socket I/O sized for the control plane (runs once at
node start); the async node calls it via `asyncio.to_thread`.

The port's copy of ``tensorlink_tpu/p2p/nat.py``, which uses no
framework: the port keeps its own so that it never imports the JAX
package. Keep the two in step.
"""

from __future__ import annotations

import re
import socket
import time
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from dataclasses import dataclass

SSDP_ADDR = ("239.255.255.250", 1900)
_SERVICE_TYPES = (
    "urn:schemas-upnp-org:service:WANIPConnection:1",
    "urn:schemas-upnp-org:service:WANPPPConnection:1",
)
_SEARCH_TARGET = "urn:schemas-upnp-org:device:InternetGatewayDevice:1"


class UpnpError(RuntimeError):
    """Discovery, description, or SOAP failure."""


# ---------------------------------------------------------------- port scan
def scan_bind_port(host: str, base_port: int, max_tries: int = 200) -> int:
    """First bindable TCP port scanning upward from `base_port`
    (reference smart_node.py:949-967). Raises OSError when the range is
    exhausted. The successful probe socket is closed; the caller re-binds
    — the same (benign) race the reference has."""
    last_err: OSError | None = None
    for port in range(base_port, base_port + max_tries):
        probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            probe.bind((host, port))
            return port
        except OSError as e:
            last_err = e
        finally:
            probe.close()
    raise OSError(
        f"no free port in [{base_port}, {base_port + max_tries})"
    ) from last_err


# --------------------------------------------------------------------- SSDP
def _ssdp_discover(timeout: float, ssdp_addr: tuple[str, int]) -> str:
    """M-SEARCH for an IGD; returns the LOCATION url of the first reply."""
    msg = (
        "M-SEARCH * HTTP/1.1\r\n"
        f"HOST: {ssdp_addr[0]}:{ssdp_addr[1]}\r\n"
        'MAN: "ssdp:discover"\r\n'
        "MX: 2\r\n"
        f"ST: {_SEARCH_TARGET}\r\n\r\n"
    ).encode()
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.sendto(msg, ssdp_addr)
        # total deadline, not per-packet: a chatty responder emitting
        # LOCATION-less replies must not keep resetting the clock and
        # stall node start
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise UpnpError("no IGD responded to SSDP discovery")
            sock.settimeout(remaining)
            data, _ = sock.recvfrom(4096)
            m = re.search(
                rb"^LOCATION:\s*(\S+)", data, re.IGNORECASE | re.MULTILINE
            )
            if m:
                return m.group(1).decode()
    except socket.timeout:
        raise UpnpError("no IGD responded to SSDP discovery") from None
    finally:
        sock.close()


def _local_ip_toward(host: str) -> str:
    """Source IP the OS would use to reach `host` (the reference's UDP
    trick, smart_node.py:120-123)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((host, 1))
        return s.getsockname()[0]
    finally:
        s.close()


# ------------------------------------------------------------------- gateway
@dataclass
class UpnpGateway:
    control_url: str
    service_type: str
    local_ip: str

    @classmethod
    def discover(
        cls, timeout: float = 3.0, ssdp_addr: tuple[str, int] = SSDP_ADDR
    ) -> "UpnpGateway":
        location = _ssdp_discover(timeout, ssdp_addr)
        try:
            with urllib.request.urlopen(location, timeout=timeout) as resp:
                tree = ET.fromstring(resp.read())
        except (OSError, ET.ParseError) as e:
            raise UpnpError(f"bad IGD description at {location}: {e}") from e
        # namespace-agnostic walk: find a WAN*Connection service
        for svc in tree.iter():
            if not svc.tag.endswith("service"):
                continue
            fields = {c.tag.rsplit("}", 1)[-1]: (c.text or "") for c in svc}
            if fields.get("serviceType") in _SERVICE_TYPES:
                if not fields.get("controlURL"):
                    continue  # malformed service entry; keep looking
                control = urllib.parse.urljoin(location, fields["controlURL"])
                host = urllib.parse.urlparse(location).hostname or ""
                return cls(
                    control_url=control,
                    service_type=fields["serviceType"],
                    local_ip=_local_ip_toward(host),
                )
        raise UpnpError("IGD description exposes no WAN*Connection service")

    # ------------------------------------------------------------------ SOAP
    def _soap(self, action: str, body_args: dict[str, str]) -> dict[str, str]:
        args = "".join(f"<{k}>{v}</{k}>" for k, v in body_args.items())
        envelope = (
            '<?xml version="1.0"?>'
            '<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/" '
            's:encodingStyle="http://schemas.xmlsoap.org/soap/encoding/">'
            f'<s:Body><u:{action} xmlns:u="{self.service_type}">{args}'
            f"</u:{action}></s:Body></s:Envelope>"
        ).encode()
        req = urllib.request.Request(
            self.control_url,
            data=envelope,
            headers={
                "Content-Type": 'text/xml; charset="utf-8"',
                "SOAPAction": f'"{self.service_type}#{action}"',
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=5.0) as resp:
                tree = ET.fromstring(resp.read())
        except urllib.error.HTTPError as e:
            raise UpnpError(f"{action} rejected: {e.read()[:200]!r}") from e
        except (OSError, ET.ParseError) as e:
            raise UpnpError(f"{action} failed: {e}") from e
        # response args are the leaf elements of the <u:...Response> body
        return {
            el.tag.rsplit("}", 1)[-1]: (el.text or "")
            for el in tree.iter()
            if len(el) == 0
        }

    def external_ip(self) -> str:
        out = self._soap("GetExternalIPAddress", {})
        ip = out.get("NewExternalIPAddress")
        if not ip:
            raise UpnpError("gateway returned no external IP")
        return ip

    def add_port_mapping(
        self,
        external_port: int,
        internal_port: int,
        proto: str = "TCP",
        description: str = "tensorlink-tpu",
        lease_s: int = 0,
    ) -> None:
        self._soap(
            "AddPortMapping",
            {
                "NewRemoteHost": "",
                "NewExternalPort": str(external_port),
                "NewProtocol": proto,
                "NewInternalPort": str(internal_port),
                "NewInternalClient": self.local_ip,
                "NewEnabled": "1",
                "NewPortMappingDescription": description,
                "NewLeaseDuration": str(lease_s),
            },
        )

    def delete_port_mapping(self, external_port: int, proto: str = "TCP") -> None:
        self._soap(
            "DeletePortMapping",
            {
                "NewRemoteHost": "",
                "NewExternalPort": str(external_port),
                "NewProtocol": proto,
            },
        )
