"""Optional ROS 1 bridge for ClusteringNode (port of
``continuous_clustering_tpu/io/ros_bridge.py``).

Maps the middleware-agnostic node onto the reference's ROS surface
(src/ros/continuous_clustering_node.cpp): subscribes ``raw_data`` /
``velodyne_points`` and TF, publishes the four topics ``raw_firings``,
``continuous_ground_point_segmentation``, ``continuous_instance_segmentation``
and ``continuous_clusters`` as PointCloud2.  Imported lazily — this module is
usable only where rospy is installed; everything else in the framework is
middleware-free.
"""

from __future__ import annotations

import numpy as np

from .node import ClusteringNode


def _require_rospy():
    try:
        import rospy  # noqa: F401
        import sensor_msgs.msg  # noqa: F401

        return True
    except ImportError as e:  # pragma: no cover - no ROS in CI
        raise ImportError(
            "ros_bridge requires rospy + sensor_msgs (source your ROS "
            "environment); the rest of continuous_clustering_tpu_torch works "
            "without ROS"
        ) from e


def structured_to_pointcloud2(cloud: np.ndarray, frame_id: str, stamp_ns: int):
    """Serialize a structured point array to sensor_msgs/PointCloud2."""
    _require_rospy()
    import rospy
    from sensor_msgs.msg import PointCloud2, PointField

    type_map = {
        np.dtype(np.float32): PointField.FLOAT32,
        np.dtype(np.float64): PointField.FLOAT64,
        np.dtype(np.uint8): PointField.UINT8,
        np.dtype(np.uint16): PointField.UINT16,
        np.dtype(np.uint32): PointField.UINT32,
        np.dtype(np.int64): PointField.FLOAT64,   # (*) 2^52 caveat, like the
        np.dtype(np.uint64): PointField.FLOAT64,  # reference ros_utils.hpp:25-27
    }
    converted = []
    for name in cloud.dtype.names:
        dt = cloud.dtype[name]
        if dt in (np.dtype(np.int64), np.dtype(np.uint64)):
            converted.append(cloud[name].astype(np.float64))
        else:
            converted.append(cloud[name])

    msg = PointCloud2()
    msg.header.frame_id = frame_id
    msg.header.stamp = rospy.Time(nsecs=stamp_ns % 10**9, secs=stamp_ns // 10**9)
    fields, offset = [], 0
    arrays = []
    for name, arr in zip(cloud.dtype.names, converted):
        fields.append(PointField(name=name, offset=offset, datatype=type_map[arr.dtype], count=1))
        offset += arr.dtype.itemsize
        arrays.append(arr)
    msg.fields = fields
    msg.point_step = offset
    msg.height = 1
    msg.width = len(cloud)
    msg.row_step = offset * len(cloud)
    packed = np.zeros(len(cloud), dtype=np.dtype({"names": cloud.dtype.names,
                                                  "formats": [a.dtype for a in arrays]}))
    for name, arr in zip(cloud.dtype.names, arrays):
        packed[name] = arr
    msg.data = packed.tobytes()
    msg.is_dense = False
    return msg


class RosBridge:
    """Run a ClusteringNode inside a ROS 1 node (reference topology)."""

    def __init__(self, node: ClusteringNode, namespace: str = "", odom_frame: str = "odom"):
        _require_rospy()
        import rospy
        from sensor_msgs.msg import PointCloud2

        self.node = node
        self.odom_frame = odom_frame
        ns = namespace.rstrip("/")
        self.pub_firings = rospy.Publisher(f"{ns}/raw_firings", PointCloud2, queue_size=1000)
        self.pub_ground = rospy.Publisher(
            f"{ns}/continuous_ground_point_segmentation", PointCloud2, queue_size=1000
        )
        self.pub_instance = rospy.Publisher(
            f"{ns}/continuous_instance_segmentation", PointCloud2, queue_size=1000
        )
        self.pub_clusters = rospy.Publisher(
            f"{ns}/continuous_clusters", PointCloud2, queue_size=1000
        )

        from .point_cloud import firing_to_structured

        def _publish_firing(firing):
            cloud = firing_to_structured(firing)
            stamp = int(np.max(firing["stamp"])) if len(firing["stamp"]) else 0
            self.pub_firings.publish(
                structured_to_pointcloud2(cloud, odom_frame, stamp)
            )

        node.publish_firing = _publish_firing
        node.publish_ground_columns = lambda cloud: self.pub_ground.publish(
            structured_to_pointcloud2(cloud, odom_frame, rospy.Time.now().to_nsec())
        )
        node.publish_instance_columns = lambda cloud: self.pub_instance.publish(
            structured_to_pointcloud2(cloud, odom_frame, rospy.Time.now().to_nsec())
        )
        node.publish_cluster = lambda pts, stamp: self.pub_clusters.publish(
            structured_to_pointcloud2(pts, odom_frame, int(stamp))
        )

        # clock / tf / ego-bbox (reference ros_utils.cpp:404-457)
        from rosgraph_msgs.msg import Clock
        from visualization_msgs.msg import Marker

        self.pub_clock = rospy.Publisher("/clock", Clock, queue_size=100)
        self.pub_ego_bbox = rospy.Publisher(
            f"{ns}/ego_robot_bounding_box", Marker, queue_size=1, latch=True
        )
        self._tf_broadcaster = None
        node.publish_clock = lambda m: self.pub_clock.publish(
            clock_message_to_ros(m)
        )
        node.publish_tf = self._send_tf
        node.publish_ego_bbox = lambda m: self.pub_ego_bbox.publish(
            marker_message_to_ros(m)
        )

    def _send_tf(self, msg):
        if self._tf_broadcaster is None:
            import tf2_ros

            self._tf_broadcaster = tf2_ros.TransformBroadcaster()
        self._tf_broadcaster.sendTransform(tf_message_to_ros(msg))

    def spin(self):  # pragma: no cover - needs a ROS master
        import rospy

        rospy.spin()


def tf_message_to_ros(msg):
    """publish_utils tf dict -> geometry_msgs/TransformStamped."""
    _require_rospy()
    import rospy
    from geometry_msgs.msg import TransformStamped

    out = TransformStamped()
    s = int(msg["stamp_ns"])
    out.header.stamp = rospy.Time(secs=s // 10**9, nsecs=s % 10**9)
    out.header.frame_id = msg["frame_id"]
    out.child_frame_id = msg["child_frame_id"]
    t, q = msg["translation"], msg["rotation_xyzw"]
    out.transform.translation.x, out.transform.translation.y, out.transform.translation.z = t
    (out.transform.rotation.x, out.transform.rotation.y,
     out.transform.rotation.z, out.transform.rotation.w) = q
    return out


def clock_message_to_ros(msg):
    """publish_utils clock dict -> rosgraph_msgs/Clock."""
    _require_rospy()
    import rospy
    from rosgraph_msgs.msg import Clock

    out = Clock()
    s = int(msg["stamp_ns"])
    out.clock = rospy.Time(secs=s // 10**9, nsecs=s % 10**9)
    return out


def marker_message_to_ros(msg):
    """publish_utils marker dict -> visualization_msgs/Marker."""
    _require_rospy()
    import rospy
    from visualization_msgs.msg import Marker

    out = Marker()
    s = int(msg["stamp_ns"])
    out.header.stamp = rospy.Time(secs=s // 10**9, nsecs=s % 10**9)
    out.header.frame_id = msg["frame_id"]
    out.ns = msg["ns"]
    out.id = msg["id"]
    out.type = Marker.CUBE
    out.color.r, out.color.g, out.color.b, out.color.a = msg["color_rgba"]
    out.scale.x, out.scale.y, out.scale.z = msg["scale"]
    (out.pose.position.x, out.pose.position.y, out.pose.position.z) = msg["position"]
    (out.pose.orientation.x, out.pose.orientation.y,
     out.pose.orientation.z, out.pose.orientation.w) = msg["orientation_xyzw"]
    out.frame_locked = msg["frame_locked"]
    return out
