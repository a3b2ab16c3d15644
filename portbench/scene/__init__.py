"""The benchmark's traffic source: the synthetic box room of the port's
``datasets/synthetic.py``, rewritten in PyTorch so that set-up renders a
whole period of frames on the card in a few batched calls, and the pose
generators (``near_corner``, ``walk``) that give every frame its
ground-truth pose.

This is the yardstick's own copy: later changes to the program's renderer
do not move the traffic.
"""

from portbench.scene.poses import POSE_GENERATORS, relative_cw
from portbench.scene.render import Camera, room_faces, render_frames, to_sensor

__all__ = ["POSE_GENERATORS", "relative_cw", "Camera", "room_faces", "render_frames", "to_sensor"]
