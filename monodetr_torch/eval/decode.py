"""NMS-free detection decoding (monodetr_tpu/eval/decode.py).

`extract_dets_from_outputs` runs on the device: flat top-k over the
(queries x classes) sigmoid scores, then the box, heading, depth, size and
sigma of each pick in the reference's 37-column layout
(decode_helper.py:57-110).  `decode_detections` and `save_results` are the
host-side numpy decode to KITTI rows and txt files, copied from the JAX
package because its module imports jax.
"""

import os
from typing import Dict, List

import numpy as np
import torch

from ..ops import box_ops
from ..ops.utils import class2angle_np
from ..utils.trace import span

CLASS_NAMES = ["Pedestrian", "Car", "Cyclist"]


def extract_dets_from_outputs(outputs: Dict, topk: int = 50) -> torch.Tensor:
    """[B, topk, 37]: label, score, x2d, y2d, w2d, h2d, depth, 24 heading,
    3 size_3d, x3d, y3d, exp(-sigma)."""
    out_logits = outputs["pred_logits"]
    B, Q, C = out_logits.shape
    prob = torch.sigmoid(out_logits.float()).reshape(B, Q * C)
    topk_values, topk_indexes = torch.topk(prob, topk, dim=1)
    topk_boxes = topk_indexes // C
    labels = topk_indexes % C

    def g(x):
        return torch.gather(x.float(), 1, topk_boxes[..., None].expand(-1, -1, x.shape[-1]))

    depth_sig = g(outputs["pred_depth"])
    boxes = g(outputs["pred_boxes"])
    xywh_2d = box_ops.box_xyxy_to_cxcywh(box_ops.box_cxcylrtb_to_xyxy(boxes))
    return torch.cat([
        labels[..., None].float(), topk_values[..., None], xywh_2d,
        depth_sig[..., 0:1], g(outputs["pred_angle"]), g(outputs["pred_3d_dim"]),
        boxes[..., 0:2], torch.exp(-depth_sig[..., 1:2]),
    ], dim=2)


def get_heading_angle(heading: np.ndarray) -> float:
    """24-vector -> alpha (decode_helper.py:175-179)."""
    heading_bin, heading_res = heading[0:12], heading[12:24]
    cls = int(np.argmax(heading_bin))
    return class2angle_np(cls, float(heading_res[cls]), to_label_format=True)


def decode_detections(dets: np.ndarray, info: Dict, calibs: List,
                      cls_mean_size: np.ndarray, threshold: float) -> Dict:
    """Per-image KITTI rows [cls_id, alpha, x1, y1, x2, y2, h, w, l, X, Y,
    Z, ry, score] of the detections scoring at least `threshold`; a
    root span `decode` of the host's time (utils/trace.py)."""
    with span("decode"):
        results = {}
        for i in range(dets.shape[0]):
            preds = []
            for j in range(dets.shape[1]):
                cls_id = int(dets[i, j, 0])
                score = dets[i, j, 1]
                if score < threshold:
                    continue

                x = dets[i, j, 2] * info["img_size"][i][0]
                y = dets[i, j, 3] * info["img_size"][i][1]
                w = dets[i, j, 4] * info["img_size"][i][0]
                h = dets[i, j, 5] * info["img_size"][i][1]
                bbox = [x - w / 2, y - h / 2, x + w / 2, y + h / 2]

                depth = dets[i, j, 6]
                dimensions = dets[i, j, 31:34] + cls_mean_size[cls_id]

                x3d = dets[i, j, 34] * info["img_size"][i][0]
                y3d = dets[i, j, 35] * info["img_size"][i][1]
                locations = calibs[i].img_to_rect(
                    np.array([x3d]), np.array([y3d]), np.array([depth])
                ).reshape(-1)
                locations[1] += dimensions[0] / 2

                alpha = get_heading_angle(dets[i, j, 7:31])
                ry = calibs[i].alpha2ry(alpha, x)

                score = score * dets[i, j, -1]
                preds.append(
                    [cls_id, alpha] + bbox + dimensions.tolist()
                    + locations.tolist() + [ry, score]
                )
            results[info["img_id"][i]] = preds
    return results


def save_results(results: Dict, output_dir: str):
    """Write one KITTI-format txt per image (tester_helper.py:112-132)."""
    os.makedirs(output_dir, exist_ok=True)
    for img_id, preds in results.items():
        with open(os.path.join(output_dir, "%06d.txt" % img_id), "w") as f:
            for p in preds:
                f.write(CLASS_NAMES[int(p[0])])
                f.write(" 0.0 0")
                for x in p[1:]:
                    f.write(" %.2f" % x)
                f.write("\n")
