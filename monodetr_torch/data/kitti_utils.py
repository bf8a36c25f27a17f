"""KITTI label / calibration primitives (host-side numpy, vectorized).

Capability parity with reference lib/datasets/kitti/kitti_utils.py — label
parsing + difficulty levels, Calibration (P2/R0/V2C projections, alpha<->ry,
SVD flip refit), and the 3-point affine warp builder — but organized
struct-of-arrays: a label file parses into one `LabelTable` whose per-object
attributes are [N]-shaped numpy arrays, and every derived quantity
(difficulty level, 2-D flip, 3-D corners) is computed for all objects at
once.  The reference's per-object `Object3d` loop (kitti_utils.py:9-82) is
deliberately not reproduced; at the target step rate the host pipeline is on
the critical path and per-object python is the enemy.

The affine builder matches cv2.getAffineTransform via a direct linear solve.
"""

import numpy as np

LEVEL_NAMES = np.array(["DontCare", "Easy", "Moderate", "Hard", "UnKnown"])


def _wrap_pi(a):
    """One wrap into (-pi, pi] — the reference's single if-based re-check."""
    a = np.where(a > np.pi, a - 2 * np.pi, a)
    return np.where(a < -np.pi, a + 2 * np.pi, a)


class LabelTable:
    """All objects of one KITTI label file as parallel arrays.

    Fields (N = number of label lines):
      cls        [N] object ndarray of class-name strings
      truncation [N] float32   (KITTI column 2; reference misspells it)
      occlusion  [N] float32
      alpha      [N] float32
      box2d      [N, 4] float32 (x1, y1, x2, y2)
      hwl        [N, 3] float32 (h, w, l)
      pos        [N, 3] float32 (camera-frame bottom-center)
      ry         [N] float32
      score      [N] float32 (-1 when the file has no score column)
      level      [N] int32 difficulty (0 DontCare / 1 Easy / 2 Moderate /
                 3 Hard / 4 UnKnown, reference kitti_utils.py:33-51)
    """

    __slots__ = ("cls", "truncation", "occlusion", "alpha", "box2d", "hwl",
                 "pos", "ry", "score", "level")

    def __init__(self, cls, vals, score):
        self.cls = cls
        self.truncation = vals[:, 0]
        self.occlusion = vals[:, 1]
        self.alpha = vals[:, 2]
        self.box2d = vals[:, 3:7]
        self.hwl = vals[:, 7:10]
        self.pos = vals[:, 10:13]
        self.ry = vals[:, 13]
        self.score = score
        self.level = self._levels()

    @classmethod
    def from_file(cls, label_file):
        with open(label_file) as f:
            rows = [line.strip().split(" ") for line in f.readlines()]
        rows = [r for r in rows if len(r) >= 15]
        names = np.array([r[0] for r in rows], dtype=object)
        if rows:
            vals = np.array([r[1:15] for r in rows], dtype=np.float32)
            score = np.array(
                [float(r[15]) if len(r) >= 16 else -1.0 for r in rows],
                dtype=np.float32,
            )
        else:
            vals = np.zeros((0, 14), np.float32)
            score = np.zeros((0,), np.float32)
        return cls(names, vals, score)

    def __len__(self):
        return len(self.cls)

    def head(self, n):
        """View of the first n objects (arrays are slices, not copies)."""
        t = object.__new__(LabelTable)
        t.cls = self.cls[:n]
        t.truncation = self.truncation[:n]
        t.occlusion = self.occlusion[:n]
        t.alpha = self.alpha[:n]
        t.box2d = self.box2d[:n]
        t.hwl = self.hwl[:n]
        t.pos = self.pos[:n]
        t.ry = self.ry[:n]
        t.score = self.score[:n]
        t.level = self.level[:n]
        return t

    def _levels(self):
        height = self.box2d[:, 3] - self.box2d[:, 1] + 1
        easy = (height >= 40) & (self.truncation <= 0.15) & (self.occlusion <= 0)
        moderate = (height >= 25) & (self.truncation <= 0.3) & (self.occlusion <= 1)
        hard = (height >= 25) & (self.truncation <= 0.5) & (self.occlusion <= 2)
        return np.select(
            [self.truncation == -1, easy, moderate, hard],
            [0, 1, 2, 3], default=4,
        ).astype(np.int32)

    @property
    def level_str(self):
        return LEVEL_NAMES[self.level]

    def flip_2d(self, img_w, flip_pos=False):
        """In-place horizontal-flip of the 2-D annotations, all objects at
        once (reference does this per object in __getitem__): mirror box2d,
        alpha/ry -> pi - angle (single wrap), optionally mirror pos.x (only
        when the calibration itself is refit, aug_calib)."""
        x1 = self.box2d[:, 0].copy()
        self.box2d[:, 0] = img_w - self.box2d[:, 2]
        self.box2d[:, 2] = img_w - x1
        self.alpha = _wrap_pi(np.pi - self.alpha).astype(np.float32)
        self.ry = _wrap_pi(np.pi - self.ry).astype(np.float32)
        if flip_pos:
            self.pos[:, 0] *= -1

    def corners3d(self):
        """[N, 8, 3] camera-frame box corners (Object3d.generate_corners3d
        vectorized: x/z in the yaw plane, y up from the bottom face)."""
        h, w, l = self.hwl[:, 0], self.hwl[:, 1], self.hwl[:, 2]
        zeros = np.zeros_like(l)
        x_c = np.stack([l / 2, l / 2, -l / 2, -l / 2] * 2, 1)
        y_c = np.stack([zeros] * 4 + [-h] * 4, 1)
        z_c = np.stack([w / 2, -w / 2, -w / 2, w / 2] * 2, 1)
        c, s = np.cos(self.ry), np.sin(self.ry)
        xr = c[:, None] * x_c + s[:, None] * z_c
        zr = -s[:, None] * x_c + c[:, None] * z_c
        return np.stack([xr, y_c, zr], -1) + self.pos[:, None, :]

    def to_kitti_lines(self):
        """KITTI label-format lines (Object3d.to_kitti_format per row)."""
        lines = []
        for i in range(len(self)):
            lines.append(
                "%s %.2f %d %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f"
                % (
                    self.cls[i], self.truncation[i], int(self.occlusion[i]),
                    self.alpha[i], self.box2d[i, 0], self.box2d[i, 1],
                    self.box2d[i, 2], self.box2d[i, 3], self.hwl[i, 0],
                    self.hwl[i, 1], self.hwl[i, 2], self.pos[i, 0],
                    self.pos[i, 1], self.pos[i, 2], self.ry[i],
                )
            )
        return lines


def read_label(label_file) -> LabelTable:
    return LabelTable.from_file(label_file)


def get_calib_from_file(calib_file):
    with open(calib_file) as f:
        lines = f.readlines()
    obj = lines[2].strip().split(" ")[1:]
    P2 = np.array(obj, dtype=np.float32)
    obj = lines[3].strip().split(" ")[1:]
    P3 = np.array(obj, dtype=np.float32)
    obj = lines[4].strip().split(" ")[1:]
    R0 = np.array(obj, dtype=np.float32)
    obj = lines[5].strip().split(" ")[1:]
    Tr = np.array(obj, dtype=np.float32)
    return {
        "P2": P2.reshape(3, 4),
        "P3": P3.reshape(3, 4),
        "R0": R0.reshape(3, 3),
        "Tr_velo2cam": Tr.reshape(3, 4),
    }


class Calibration:
    def __init__(self, calib_file):
        calib = get_calib_from_file(calib_file) if isinstance(calib_file, str) else calib_file
        self.P2 = calib["P2"]
        self.R0 = calib["R0"]
        self.V2C = calib["Tr_velo2cam"]
        self._refresh_intrinsics()

    def _refresh_intrinsics(self):
        self.cu = self.P2[0, 2]
        self.cv = self.P2[1, 2]
        self.fu = self.P2[0, 0]
        self.fv = self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

    @classmethod
    def from_p2(cls, P2):
        return cls({"P2": np.asarray(P2, np.float32),
                    "R0": np.eye(3, dtype=np.float32),
                    "Tr_velo2cam": np.zeros((3, 4), np.float32)})

    def cart_to_hom(self, pts):
        return np.hstack((pts, np.ones((pts.shape[0], 1), dtype=np.float32)))

    def rect_to_img(self, pts_rect):
        pts_rect_hom = self.cart_to_hom(pts_rect)
        pts_2d_hom = np.dot(pts_rect_hom, self.P2.T)
        pts_img = (pts_2d_hom[:, 0:2].T / pts_rect_hom[:, 2]).T
        pts_rect_depth = pts_2d_hom[:, 2] - self.P2.T[3, 2]
        return pts_img, pts_rect_depth

    def img_to_rect(self, u, v, depth_rect):
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.concatenate(
            (x.reshape(-1, 1), y.reshape(-1, 1), depth_rect.reshape(-1, 1)), axis=1
        )

    def alpha2ry(self, alpha, u):
        """Observation angle -> yaw; scalar or [N] arrays."""
        return _wrap_pi(alpha + np.arctan2(u - self.cu, self.fu))

    def ry2alpha(self, ry, u):
        """Yaw -> observation angle; scalar or [N] arrays."""
        return _wrap_pi(ry - np.arctan2(u - self.cu, self.fu))

    def flip(self, img_size):
        """Refit P2 for a horizontally flipped image via least squares over a
        grid of correspondences (kitti_utils.py:296-328)."""
        wsize, hsize = 4, 2
        p2ds = (
            np.concatenate(
                [
                    np.expand_dims(
                        np.tile(np.expand_dims(np.linspace(0, img_size[0], wsize), 0), [hsize, 1]),
                        -1,
                    ),
                    np.expand_dims(
                        np.tile(np.expand_dims(np.linspace(0, img_size[1], hsize), 1), [1, wsize]),
                        -1,
                    ),
                    np.linspace(2, 78, wsize * hsize).reshape(hsize, wsize, 1),
                ],
                -1,
            )
        ).reshape(-1, 3)
        p3ds = self.img_to_rect(p2ds[:, 0:1], p2ds[:, 1:2], p2ds[:, 2:3])
        p3ds[:, 0] *= -1
        p2ds[:, 0] = img_size[0] - p2ds[:, 0]

        cos_matrix = np.zeros([wsize * hsize, 2, 7])
        cos_matrix[:, 0, 0] = p3ds[:, 0]
        cos_matrix[:, 0, 1] = cos_matrix[:, 1, 2] = p3ds[:, 2]
        cos_matrix[:, 1, 0] = p3ds[:, 1]
        cos_matrix[:, 0, 3] = cos_matrix[:, 1, 4] = 1
        cos_matrix[:, :, -2] = -p2ds[:, :2]
        cos_matrix[:, :, -1] = -p2ds[:, :2] * p3ds[:, 2:3]
        new_calib = np.linalg.svd(cos_matrix.reshape(-1, 7))[-1][-1]
        new_calib /= new_calib[-1]

        new_calib_matrix = np.zeros([4, 3]).astype(np.float32)
        new_calib_matrix[0, 0] = new_calib_matrix[1, 1] = new_calib[0]
        new_calib_matrix[2, 0:2] = new_calib[1:3]
        new_calib_matrix[3, :] = new_calib[3:6]
        new_calib_matrix[-1, -1] = self.P2[-1, -1]
        self.P2 = new_calib_matrix.T
        self._refresh_intrinsics()


def get_dir(src_point, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return [
        src_point[0] * cs - src_point[1] * sn,
        src_point[0] * sn + src_point[1] * cs,
    ]


def get_3rd_point(a, b):
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def _solve_affine(src, dst):
    """Exact 3-point affine solve (what cv2.getAffineTransform computes)."""
    A = np.zeros((6, 6), np.float64)
    b = np.zeros(6, np.float64)
    for i in range(3):
        A[2 * i, 0:2] = src[i]
        A[2 * i, 2] = 1
        A[2 * i + 1, 3:5] = src[i]
        A[2 * i + 1, 5] = 1
        b[2 * i] = dst[i][0]
        b[2 * i + 1] = dst[i][1]
    x = np.linalg.solve(A, b)
    return x.reshape(2, 3)


def get_affine_transform(center, scale, rot, output_size,
                         shift=np.array([0, 0], dtype=np.float32), inv=0):
    """Crop/scale/rotate affine builder (kitti_utils.py:347-381)."""
    if not isinstance(scale, (np.ndarray, list)):
        scale = np.array([scale, scale], dtype=np.float32)

    src_w = scale[0]
    dst_w, dst_h = output_size[0], output_size[1]

    rot_rad = np.pi * rot / 180
    src_dir = get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0, :] = center + scale * shift
    src[1, :] = center + src_dir + scale * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5], np.float32) + dst_dir
    src[2:, :] = get_3rd_point(src[0, :], src[1, :])
    dst[2:, :] = get_3rd_point(dst[0, :], dst[1, :])

    trans = _solve_affine(src, dst)
    if inv:
        trans_inv = _solve_affine(dst, src)
        return trans, trans_inv
    return trans


def affine_transform(pt, t):
    """Apply a 2x3 affine to points: [2] or [N, 2] -> same shape."""
    pt = np.asarray(pt, np.float64)
    if pt.ndim == 1:
        return (t[:, :2] @ pt + t[:, 2]).astype(np.float32)
    return (pt @ t[:, :2].T + t[:, 2]).astype(np.float32)
