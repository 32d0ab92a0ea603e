"""Precomputed proposals (the port's copy of cddmsl_tpu/data/proposals.py):
a proposal file's boxes and objectness logits attached to the dataset dicts
by image id; the mapper moves them with the image, clips them, drops the
empty ones and keeps the top-k by objectness.

File formats: .npz, or a pickle (.pkl / .npy of a pickled dict), with
  ids                 image ids (str or int)
  boxes               (N_i, 4) float XYXY arrays
  objectness_logits   (N_i,) float arrays ("scores" in older files)."""

import pickle
from typing import Dict, List

import numpy as np


def load_proposal_file(path: str) -> Dict[str, object]:
    if path.endswith(".npz"):
        f = np.load(path, allow_pickle=True)
        return {"ids": list(f["ids"]), "boxes": list(f["boxes"]), "objectness_logits": list(f["objectness_logits"])}
    with open(path, "rb") as fh:
        data = pickle.load(fh)
    if "scores" in data and "objectness_logits" not in data:  # detectron2's older key
        data["objectness_logits"] = data.pop("scores")
    return data


def load_proposals_into_dataset(dicts: List[dict], proposal_file: str) -> List[dict]:
    """New dicts with "proposal_boxes" and "proposal_objectness_logits"
    where the file has the image's id."""
    data = load_proposal_file(proposal_file)
    by_id = {str(i): k for k, i in enumerate(data["ids"])}
    out = []
    for d in dicts:
        d = dict(d)
        k = by_id.get(str(d.get("image_id")))
        if k is not None:
            d["proposal_boxes"] = np.asarray(data["boxes"][k], np.float32).reshape(-1, 4)
            d["proposal_objectness_logits"] = np.asarray(data["objectness_logits"][k], np.float32).reshape(-1)
        out.append(d)
    return out


def transform_proposals(dataset_dict: dict, image_hw, tfms, topk: int) -> dict:
    """The dict's proposals through `tfms`, clipped to `image_hw`, the empty
    ones dropped, the top `topk` by objectness (a stable descending order
    of numpy's argsort of the negated logits); {} without proposals."""
    if "proposal_boxes" not in dataset_dict:
        return {}
    boxes = tfms.apply_box(np.asarray(dataset_dict["proposal_boxes"], np.float32))
    h, w = image_hw
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w)
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h)
    logits = np.asarray(dataset_dict["proposal_objectness_logits"], np.float32)
    keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    boxes, logits = boxes[keep], logits[keep]
    order = np.argsort(-logits)[:topk]
    return {"proposal_boxes": boxes[order], "proposal_objectness": logits[order]}
