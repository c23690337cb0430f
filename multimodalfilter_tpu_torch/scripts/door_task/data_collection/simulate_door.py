"""Door-task data collection (port of
``scripts/door_task/data_collection/simulate_door.py``).

    python -m multimodalfilter_tpu_torch.scripts.door_task.data_collection.simulate_door \
        --output door.hdf5 [--policy pull|push] [--num-trajectories 10] [--synthetic]

Behavior parity with the reference
``scripts/door_task/data_collection/simulate_door.py``: drives a robosuite
"PandaDoor" environment at 20 Hz with a position controller and a 64x64
birdview camera (:35-49), rolls out push/pull waypoint policies, grayscales
images to [-1, 1] via mean(RGB)/127.5 - 1 (:114), tracks a leaky
joint-limit/missing-contact failure counter (+1 on a bad step, x0.9 decay on
a good one; abandon past 400, :101-111), ends push rollouts when the door
re-closes (:125-131), and streams accepted trajectories into an HDF5
``TrajectoriesFile``: an episode that ends in persistent joint limits is
abandoned, every other (missing contact, closed door, max iteration) is kept
(:139-145).

``run_episode`` is written against the small env surface the policies use
(``hand_position``/``hand_speed`` in waypoint_policies.py, and the hinge and
joint-limit accessors here), so it runs against a mock env without
robosuite or MuJoCo. ``--synthetic`` writes schema-compatible synthetic
trajectories (``data/synthetic.py``) instead of simulating; without
robosuite, the simulation raises ``ImportError`` naming it.
"""

from __future__ import annotations

import argparse

import numpy as np

from ....data import TrajectoriesFile
from .waypoint_policies import PullWaypointPolicy, PushWaypointPolicy

# Leaky failure-counter abandonment threshold (reference simulate_door.py:110).
FAILURE_COUNTER_LIMIT = 400.0
MAX_ITERATIONS = 800  # reference :90


def grayscale(image_rgb: np.ndarray) -> np.ndarray:
    """RGB uint8 -> [-1, 1] grayscale (reference simulate_door.py:114)."""
    return np.mean(np.asarray(image_rgb, dtype=np.float32), axis=-1) / 127.5 - 1.0


def _door_hinge_angle(env) -> float:
    """Door hinge angle: robosuite's qpos (reference :126-129), or a mock
    env's ``door_hinge_angle``."""
    sim = getattr(env, "sim", None)
    if sim is not None:
        return float(sim.data.qpos[sim.model.get_joint_qpos_addr("door_hinge")])
    return float(env.door_hinge_angle)


def _set_door_hinge(env, value: float) -> None:
    """Set the initial door hinge angle (reference :78-80)."""
    sim = getattr(env, "sim", None)
    if sim is not None:
        sim.data.qpos[sim.model.get_joint_qpos_addr("door_hinge")] = value
    else:
        env.door_hinge_angle = float(value)


def run_episode(env, policy, trajectories_file: TrajectoriesFile,
                max_iterations: int = MAX_ITERATIONS, process_images: bool = True) -> str:
    """Roll out one episode; returns the termination cause.

    The reference main loop (simulate_door.py:56-145): reset, place the arm
    and door from the policy's initial state, step the waypoint FSM,
    accumulate the leaky failure counter, then complete or abandon the
    buffered trajectory by the cause.
    """
    obs = env.reset()

    # The reference resets the position controller's goal after reset
    # (:60-62); mock envs have no controller.
    controller = getattr(env, "controller", None)
    if controller is not None:
        controller.step = 0.0
        controller.last_goal_position = np.array((0.0, 0.0, 0.0))
        controller.last_goal_orientation = np.eye(3)

    initial_joints, initial_door = policy.get_initial_state()
    env.set_robot_joint_positions(initial_joints)
    _set_door_hinge(env, initial_door)

    failure_counter = 0.0
    # The cause is sticky: the most recent failure (or the closed-door
    # break), overridden to "max iteration" only when the loop runs to its
    # end (reference :101-136).
    termination_cause = "max iteration"
    for i in range(max_iterations):
        action = policy.update(env)
        obs, reward, done, info = env.step(action)

        # Leaky failure counter: +1 on joint limits or lost contact, x0.9
        # on a healthy step; a persistent failure aborts (:101-111).
        if env._check_q_limits():
            failure_counter += 1.0
            termination_cause = "joint limits"
        elif not obs["contact-obs"]:
            failure_counter += 1.0
            termination_cause = "missing contact"
        else:
            failure_counter *= 0.9
        if failure_counter > FAILURE_COUNTER_LIMIT:
            break

        if process_images and "image" in obs:
            obs = dict(obs)
            obs["image"] = grayscale(obs["image"])

        # Push rollouts end when the door swings shut again (:125-131).
        if isinstance(policy, PushWaypointPolicy) and _door_hinge_angle(env) < 0.01:
            termination_cause = "closed door"
            break

        trajectories_file.add_timestep(obs)
    if i == max_iterations - 1:
        termination_cause = "max iteration"

    # The data are usually garbage after a persistent joint-limit failure;
    # everything else is kept (:139-145).
    if termination_cause != "joint limits":
        trajectories_file.complete_trajectory()
    else:
        trajectories_file.abandon_trajectory()
    return termination_cause


def collect_robosuite(args) -> None:
    try:
        import robosuite
        from robosuite.wrappers import IKWrapper
    except ImportError as exc:
        raise ImportError(
            "simulating the door task needs robosuite (and MuJoCo), which is not "
            "installed; --synthetic writes schema-compatible synthetic data instead"
        ) from exc

    env = robosuite.make(
        "PandaDoor",
        placement_initializer=True,
        has_renderer=False,
        ignore_done=True,
        use_camera_obs=True,
        camera_name="birdview",
        camera_height=64,
        camera_width=64,
        gripper_visualization=True,
        reward_shaping=True,
        control_freq=20,
        controller="position",
        camera_depth=True,
    )
    ik_controller = IKWrapper(env).controller
    rng = np.random.default_rng(args.seed)

    with TrajectoriesFile(args.output, "a") as f:
        while len(f) < args.num_trajectories:
            door_offset = env.model.door_offset
            if args.policy == "pull":
                policy = PullWaypointPolicy(door_offset, ik_controller, rng=rng)
            else:
                policy = PushWaypointPolicy(door_offset, rng=rng)
            cause = run_episode(env, policy, f, max_iterations=args.max_steps)
            print(f"Terminated rollout #{len(f)}: {cause}")


def collect_synthetic(args) -> None:
    from ....data import synthetic

    synthetic._synthesize_door(args.output, args.num_trajectories, args.seed)
    print(f"synthesized {args.num_trajectories} trajectories -> {args.output}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--policy", choices=["pull", "push"], default="pull")
    parser.add_argument("--num-trajectories", type=int, default=10)
    parser.add_argument("--max-steps", type=int, default=MAX_ITERATIONS)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--synthetic", action="store_true",
                        help="write schema-compatible synthetic data (no MuJoCo needed)")
    args = parser.parse_args(argv)
    if args.synthetic:
        collect_synthetic(args)
    else:
        collect_robosuite(args)


if __name__ == "__main__":
    main()
