"""Waypoint-following policies for door-task data collection (copy of
``scripts/door_task/data_collection/waypoint_policies.py``, which is plain
numpy).

Behavior parity with the reference
``scripts/door_task/data_collection/waypoint_policies.py``:

- a waypoint FSM (READY -> ACTIVE -> WAITING) where READY samples a fresh
  waypoint plus a log-uniform action scale ``exp(U(0, ln 100))`` and an
  ACTIVE-step budget ``U(100, 250)`` (:58-70), ACTIVE moves the hand with a
  scaled position delta until arrival (dist <= 0.06), budget exhaustion, or a
  velocity stall (>=5 steps and hand speed < 0.01) (:72-95), and WAITING
  idles for ``U(0, 5)`` steps before re-arming (:97-104);
- a push policy alternating retract/push cycles against the door face with
  the retract/push sample boxes and the advancing ``push_x`` frontier
  (:107-144);
- a pull policy that starts from an IK solution placing the gripper on the
  door handle (:175-216) and samples waypoints by arc-length interpolation
  along a fixed pull arc with (0.015, 0.015, 0) Gaussian noise (:218-248).

Actions are 4-vectors ``(dx, dy, dz, gripper)`` with the gripper held closed
(-1), matching the robosuite position controller interface the reference
drives. These policies run on the host; robosuite is only
needed for the real-sim path — the FSM itself runs against any env exposing
the small surface used here (see ``hand_position`` / ``hand_speed``), which
is how the mock-env tests exercise it.
"""

from __future__ import annotations

import abc
import enum
from typing import Optional, Sequence, Tuple

import numpy as np


def hand_position(env) -> np.ndarray:
    """Current end-effector position.

    robosuite path: ``sim.data.body_xpos[body_name2id("right_hand")]``
    (reference waypoint_policies.py:74-75); mock/test envs expose a plain
    ``hand_pos`` attribute instead.
    """
    sim = getattr(env, "sim", None)
    if sim is not None:
        return np.array(sim.data.body_xpos[sim.model.body_name2id("right_hand")])
    return np.asarray(env.hand_pos, dtype=float)


def hand_speed(env) -> float:
    """Current end-effector speed (norm of the total hand velocity,
    reference waypoint_policies.py:84)."""
    vel = getattr(env, "_right_hand_total_velocity", None)
    if vel is None:
        vel = getattr(env, "hand_velocity", np.zeros(3))
    return float(np.linalg.norm(np.asarray(vel, dtype=float)))


class AbstractWaypointPolicy(abc.ABC):
    """Waypoint FSM (reference waypoint_policies.py:13-104)."""

    class States(enum.Enum):
        READY = 1
        ACTIVE = 2
        WAITING = 3

    # Arrival / stall / budget constants (reference :61-89).
    ARRIVAL_DIST = 0.06
    STALL_SPEED = 0.01
    STALL_MIN_STEPS = 5

    def __init__(self, rng: Optional[np.random.Generator] = None):
        self.rng = rng if rng is not None else np.random.default_rng()
        self._state = self.States.READY
        self.counter = 0
        self.counter_threshold = 0.0
        self.delta_scale = 0.0
        self.target_pos: Optional[np.ndarray] = None

    # Policy-specific hooks ------------------------------------------------
    @abc.abstractmethod
    def get_initial_state(self) -> Tuple[np.ndarray, float]:
        """(initial joint angles, initial door hinge angle) for env setup."""

    @abc.abstractmethod
    def _sample_waypoint(self) -> np.ndarray:
        """Next target position for the end effector."""

    # FSM ------------------------------------------------------------------
    def update(self, env) -> np.ndarray:
        """One control step -> action ``(dx, dy, dz, gripper=-1)``."""
        if self._state == self.States.READY:
            return self._ready()
        if self._state == self.States.ACTIVE:
            return self._active(env)
        assert self._state == self.States.WAITING
        return self._waiting()

    def _ready(self) -> np.ndarray:
        # Arm a new waypoint: log-uniform delta scale in [1, 100] and an
        # ACTIVE budget of 100-250 steps (reference :58-67).
        self.target_pos = self._sample_waypoint()
        self.delta_scale = float(np.exp(self.rng.uniform(0.0, np.log(100.0))))
        self.counter = 0
        self.counter_threshold = float(self.rng.uniform(100, 250))
        self._state = self.States.ACTIVE
        return np.array([0.0, 0.0, 0.0, -1.0])

    def _active(self, env) -> np.ndarray:
        dpos = self.target_pos - hand_position(env)
        self.counter += 1
        arrived = np.linalg.norm(dpos) <= self.ARRIVAL_DIST
        exhausted = self.counter >= self.counter_threshold
        stalled = (
            self.counter >= self.STALL_MIN_STEPS
            and hand_speed(env) < self.STALL_SPEED
        )
        if arrived or exhausted or stalled:
            # Settle for 0-5 steps with a zeroed action scale (:87-91).
            self._state = self.States.WAITING
            self.counter = 0
            self.counter_threshold = float(self.rng.uniform(0, 5))
            self.delta_scale = 0.0
        return np.concatenate([dpos * self.delta_scale, [-1.0]])

    def _waiting(self) -> np.ndarray:
        self.counter += 1
        if self.counter >= self.counter_threshold:
            self._state = self.States.READY
        return np.array([0.0, 0.0, 0.0, -1.0])


class PushWaypointPolicy(AbstractWaypointPolicy):
    """Alternating retract/push cycles against the door face (reference
    waypoint_policies.py:107-144)."""

    class PushStates(enum.Enum):
        RETRACTED = 1
        NEED_RETRACT = 2

    def __init__(
        self,
        door_offset: Tuple[float, float] = (0.0, 0.0),
        rng: Optional[np.random.Generator] = None,
    ):
        super().__init__(rng=rng)
        self.push_state = self.PushStates.NEED_RETRACT
        self.push_x = 0.14
        self.door_offset = np.array(tuple(door_offset) + (0.0,))

    def get_initial_state(self) -> Tuple[np.ndarray, float]:
        # Fixed arm pose in front of the door; door ajar at U(0.8, 1.2) rad
        # (reference :118-122).
        initial_joints = np.array(
            [-0.055, -0.173, -0.983, -1.899, 1.48, 2.156, -1.125]
        )
        initial_door = float(self.rng.uniform(0.8, 1.2))
        return initial_joints, initial_door

    def _sample_waypoint(self) -> np.ndarray:
        if self.push_state == self.PushStates.NEED_RETRACT:
            # Pull back behind the current push frontier (:126-132).
            waypoint = self.rng.uniform(
                [0.14, -0.3, 1.544], [self.push_x, 0.0, 1.546 + 0.15]
            )
            self.push_state = self.PushStates.RETRACTED
        else:
            # Push forward of the frontier; the reached x becomes the new
            # frontier (:133-140).
            waypoint = self.rng.uniform(
                [self.push_x, -0.3, 1.544], [0.67, 0.19, 1.546 + 0.15]
            )
            self.push_x = float(waypoint[0])
            self.push_state = self.PushStates.NEED_RETRACT
        return waypoint + self.door_offset


class PullWaypointPolicy(AbstractWaypointPolicy):
    """Pull the door open along a fixed arc (reference
    waypoint_policies.py:147-248)."""

    # Handle-to-open arc in world coordinates (reference :149-159).
    PULL_WAYPOINTS = np.array(
        [
            [0.58220392, 0.16180555, 1.54591789],
            [0.582, 0.162, 1.546],
            [0.472, 0.122, 1.546],
            [0.339, -0.012, 1.546],
            [0.247, -0.219, 1.545],
            [0.283, -0.461, 1.545],
        ]
    )
    REST_JOINTS = np.array([-1.609, -0.615, 1.696, -1.627, 1.782, 3.228, -0.498])

    def __init__(
        self,
        door_offset: Tuple[float, float] = (0.0, 0.0),
        ik_controller=None,
        rng: Optional[np.random.Generator] = None,
    ):
        super().__init__(rng=rng)
        self.pull_waypoints = (
            self.PULL_WAYPOINTS
            + np.array(tuple(door_offset) + (0.0,))[np.newaxis, :]
        )
        self.ik_controller = ik_controller

    def get_initial_state(self) -> Tuple[np.ndarray, float]:
        """IK the gripper onto the door handle (reference :175-216); without
        an IK controller (no robosuite) fall back to the rest pose the IK
        refinement would have started from."""
        if self.ik_controller is None:
            return self.REST_JOINTS.copy(), 0.0

        # Nominal gripper orientation from the rest pose's FK.
        self.ik_controller.sync_ik_robot(self.REST_JOINTS)
        _, orientation = self.ik_controller.forward_kinematics()
        orientation = np.array(orientation)

        # Iteratively refine IK until FK error < 1e-4 (cap 2000 iterations).
        target_position = self.pull_waypoints[0]
        iterations = 0
        while True:
            ik_solution = np.array(
                self.ik_controller.inverse_kinematics(
                    target_position, orientation, rest_poses=self.REST_JOINTS
                )
            )
            self.ik_controller.sync_ik_robot(ik_solution)
            position, _ = self.ik_controller.forward_kinematics()
            error = np.linalg.norm(position - target_position, ord=np.inf)
            if error < 1e-4 or iterations > 2000:
                break
            iterations += 1
        assert ik_solution.shape == self.REST_JOINTS.shape
        return ik_solution, 0.0

    def _sample_waypoint(self) -> np.ndarray:
        # A uniformly-random arc-length fraction along the pull arc, with
        # planar Gaussian noise (reference :218-222).
        alpha = float(self.rng.uniform(0.0, 1.0))
        waypoint = interpolate_waypoint(self.pull_waypoints, alpha)
        noise = self.rng.normal(0.0, (0.015, 0.015, 0.0))
        return waypoint + noise


def interpolate_waypoint(waypoints: Sequence[np.ndarray], alpha: float) -> np.ndarray:
    """Point at arc-length fraction ``alpha`` along the piecewise-linear path
    through ``waypoints`` (reference waypoint_policies.py:224-248)."""
    waypoints = np.asarray(waypoints, dtype=float)
    assert 0.0 <= alpha <= 1.0
    if alpha <= 1e-9:
        return waypoints[0]

    segment_lengths = np.linalg.norm(waypoints[:-1] - waypoints[1:], axis=1)
    cum = np.zeros(len(waypoints))
    cum[1:] = np.cumsum(segment_lengths)
    cum /= cum[-1]

    end_index = int(np.searchsorted(cum, alpha))
    start_index = end_index - 1
    assert start_index >= 0

    local = (alpha - cum[start_index]) / (cum[end_index] - cum[start_index])
    assert 0.0 <= local <= 1.0
    return (1 - local) * waypoints[start_index] + local * waypoints[end_index]
