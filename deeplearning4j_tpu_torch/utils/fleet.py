"""Worker-fleet provisioning: the JAX package's ``utils/fleet.py``, the
same host code (reference deeplearning4j-aws: aws/ec2/Ec2BoxCreator.java
— create() / createSpot() / blockTillAllRunning() / getHosts() /
blowupBoxes() over the EC2 API).

The lifecycle drives pluggable cloud drivers:

- ``Boto3Ec2Driver``: EC2 through boto3 (import-gated, like
  S3ObjectStore; a client can be injected), the Ec2BoxCreator.java:129
  analog;
- ``GcloudTpuDriver``: TPU VMs through the gcloud CLI, with a dry run
  and an injectable command runner;
- ``InMemoryDriver``: a state machine (pending → running → terminated)
  with no cloud behind it, the test double.

Nothing here opens a connection unless a real driver is asked to.
"""

from __future__ import annotations

import subprocess
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Instance:
    instance_id: str
    host: str = ""
    state: str = "pending"        # pending | running | terminated
    spot: bool = False


class CloudDriver:
    def launch(self, count: int, spec: dict, spot: bool) -> List[Instance]:
        raise NotImplementedError

    def describe(self, ids: List[str]) -> List[Instance]:
        raise NotImplementedError

    def terminate(self, ids: List[str]) -> None:
        raise NotImplementedError


class InMemoryDriver(CloudDriver):
    """Cloudless state machine: instances become running after
    ``startup_delay`` seconds (0 = immediately)."""

    def __init__(self, startup_delay: float = 0.0):
        self.startup_delay = float(startup_delay)
        self._instances: Dict[str, Instance] = {}
        self._launched_at: Dict[str, float] = {}

    def launch(self, count, spec, spot):
        out = []
        for i in range(count):
            iid = f"i-{uuid.uuid4().hex[:12]}"
            inst = Instance(iid, host=f"10.0.0.{len(self._instances) + 1}",
                            state="pending", spot=spot)
            self._instances[iid] = inst
            self._launched_at[iid] = time.monotonic()
            out.append(inst)
        return out

    def describe(self, ids):
        now = time.monotonic()
        out = []
        for iid in ids:
            inst = self._instances[iid]
            if inst.state == "pending" and \
                    now - self._launched_at[iid] >= self.startup_delay:
                inst.state = "running"
            out.append(inst)
        return out

    def terminate(self, ids):
        for iid in ids:
            self._instances[iid].state = "terminated"


class Boto3Ec2Driver(CloudDriver):
    """Real EC2 (reference Ec2BoxCreator.create / createSpot / blowupBoxes).
    boto3 is import-gated exactly like S3ObjectStore; ``client`` injects a
    pre-built (or recorded-response fake) EC2 client so the request/parse
    logic runs in CI without credentials."""

    def __init__(self, region: Optional[str] = None, client=None,
                 **client_kwargs):
        if client is not None:
            self._ec2 = client
            return
        try:
            import boto3
        except ImportError as e:         # pragma: no cover - env without boto3
            raise ImportError(
                "boto3 is required for Boto3Ec2Driver; use InMemoryDriver "
                "for cloudless tests") from e
        if region:
            client_kwargs.setdefault("region_name", region)
        self._ec2 = boto3.client("ec2", **client_kwargs)

    def launch(self, count, spec, spot):
        kwargs = dict(ImageId=spec["ami_id"], InstanceType=spec["size"],
                      MinCount=count, MaxCount=count,
                      SecurityGroupIds=[spec["security_group_id"]],
                      KeyName=spec["key_pair"])
        if spot:
            kwargs["InstanceMarketOptions"] = {"MarketType": "spot"}
        resp = self._ec2.run_instances(**kwargs)
        return [Instance(i["InstanceId"], state="pending", spot=spot)
                for i in resp["Instances"]]

    def describe(self, ids):
        resp = self._ec2.describe_instances(InstanceIds=ids)
        out = []
        for r in resp["Reservations"]:
            for i in r["Instances"]:
                out.append(Instance(
                    i["InstanceId"],
                    host=i.get("PublicIpAddress") or
                    i.get("PrivateIpAddress", ""),
                    state=i["State"]["Name"]))
        return out

    def terminate(self, ids):
        self._ec2.terminate_instances(InstanceIds=ids)


class GcloudTpuDriver(CloudDriver):
    """TPU-VM fleets via the gcloud CLI (the target hardware; subsumes
    FleetSpec.render_launch_commands by actually running the commands)."""

    def __init__(self, zone: str = "us-central2-b",
                 accelerator_type: str = "v5litepod-8",
                 runtime_version: str = "tpu-ubuntu2204-base",
                 name_prefix: str = "dl4j-tpu-worker", dry_run: bool = False,
                 runner=None):
        self.zone = zone
        self.accelerator_type = accelerator_type
        self.runtime_version = runtime_version
        self.name_prefix = name_prefix
        self.dry_run = dry_run
        # injectable command runner (argv list -> CompletedProcess-like)
        # so the non-dry-run request/parse paths execute in CI against
        # recorded gcloud outputs
        # no check=True: production and injected runners share one failure
        # path — describe() maps nonzero polls to 'pending' (a transient
        # gcloud error mid-provisioning must not abort the polling loop)
        # while _run raises with the captured stderr
        self._runner = runner if runner is not None else \
            (lambda argv: subprocess.run(argv, capture_output=True))
        self.commands_run: List[str] = []

    def _run(self, cmd: str):
        self.commands_run.append(cmd)
        if not self.dry_run:
            r = self._runner(cmd.split())
            if getattr(r, "returncode", 0) != 0:
                err = r.stderr.decode(errors="replace") \
                    if isinstance(r.stderr, bytes) else (r.stderr or "")
                raise RuntimeError(
                    f"command failed ({r.returncode}): {cmd}: "
                    f"{err.strip()}")

    def launch(self, count, spec, spot):
        out = []
        # unique names per launch: a fixed -0..-N scheme collides on the
        # second launch (create fails; blowup deletes the other fleet)
        batch = uuid.uuid4().hex[:6]
        for i in range(count):
            name = f"{self.name_prefix}-{batch}-{i}"
            cmd = (f"gcloud compute tpus tpu-vm create {name} "
                   f"--zone={self.zone} "
                   f"--accelerator-type={self.accelerator_type} "
                   f"--version={self.runtime_version}")
            if spot:
                cmd += " --spot"
            self._run(cmd)
            out.append(Instance(name, host=name,
                                state="running" if self.dry_run
                                else "pending", spot=spot))
        return out

    def describe(self, ids):
        if self.dry_run:
            return [Instance(i, host=i, state="running") for i in ids]
        out = []
        for name in ids:
            r = self._runner(
                ["gcloud", "compute", "tpus", "tpu-vm", "describe", name,
                 f"--zone={self.zone}", "--format=value(state)"])
            stdout = r.stdout.decode() if isinstance(r.stdout, bytes) \
                else (r.stdout or "")
            state = stdout.strip().lower() if r.returncode == 0 else \
                "pending"
            out.append(Instance(
                name, host=name,
                state="running" if state == "ready" else state))
        return out

    def terminate(self, ids):
        for name in ids:
            self._run(f"gcloud compute tpus tpu-vm delete {name} "
                      f"--zone={self.zone} --quiet")


class Ec2BoxCreator:
    """Reference-named fleet lifecycle (aws/ec2/Ec2BoxCreator.java):

        creator = Ec2BoxCreator(num_boxes=4, size="c5.xlarge",
                                security_group_id=..., key_pair=...,
                                driver=InMemoryDriver())
        creator.create()                # or create_spot()
        creator.block_till_all_running()
        hosts = creator.get_hosts()
        ...
        creator.blowup_boxes()          # terminate everything
    """

    def __init__(self, num_boxes: int, size: str = "c5.xlarge",
                 security_group_id: str = "", key_pair: str = "",
                 ami_id: str = "", region: Optional[str] = None,
                 driver: Optional[CloudDriver] = None):
        self.num_boxes = int(num_boxes)
        self.spec = {"size": size, "security_group_id": security_group_id,
                     "key_pair": key_pair, "ami_id": ami_id}
        self.region = region
        self.driver = driver if driver is not None else \
            Boto3Ec2Driver(region=region)
        self._boxes: List[Instance] = []

    def set_region(self, region: str):
        self.region = region
        return self

    # -- lifecycle (reference method names) ----------------------------
    def create(self):
        self._boxes = self.driver.launch(self.num_boxes, self.spec,
                                         spot=False)

    def create_spot(self):
        self._boxes = self.driver.launch(self.num_boxes, self.spec,
                                         spot=True)

    def all_running(self) -> bool:
        if not self._boxes:
            return False
        states = self.driver.describe(self.get_boxes_created())
        # an empty/partial describe means boxes are unaccounted for, NOT
        # vacuously running
        return len(states) == len(self._boxes) and \
            all(i.state == "running" for i in states)

    def block_till_all_running(self, timeout: float = 300.0,
                               poll: float = 1.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.all_running():
                return
            time.sleep(poll)
        raise TimeoutError(
            f"fleet not running within {timeout}s: "
            f"{[(i.instance_id, i.state) for i in self.driver.describe(self.get_boxes_created())]}")

    def get_boxes_created(self) -> List[str]:
        return [b.instance_id for b in self._boxes]

    def get_hosts(self) -> List[str]:
        return [i.host for i in self.driver.describe(
            self.get_boxes_created())]

    def blowup_boxes(self) -> List[str]:
        """Terminate every created box (reference blowupBoxes)."""
        ids = self.get_boxes_created()
        if ids:
            self.driver.terminate(ids)
        return ids
