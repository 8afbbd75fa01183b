"""Built-in model and training configurations (the port's own copy).

Counterpart of :mod:`pointgnn_tpu.configs` (``model_config``,
``layer_configs``, ``get_config``, ``train_config``, ``eval_config``,
``get_train_config``, ``tpu_settings``, ``list_configs``): the same
reference-schema dicts, so a config is interchangeable between the two
packages.  ``tpu_settings`` keeps its name: it holds the family's static
graph capacities and the training compute dtype, which the port uses on
the GPU as they are.
"""

from typing import Dict, List

from pointgnn_tpu_torch.graph.pad import GraphCapacity

_MLP_WIDTH = 300


def _pooling_layer():
    return {
        "scope": "layer1",
        "type": "scatter_max_point_set_pooling",
        "graph_level": 0,
        "kwargs": {
            "point_MLP_depth_list": [32, 64, 128, _MLP_WIDTH],
            "point_MLP_normalization_type": "NONE",
            "point_MLP_activation_type": "ReLU",
            "output_MLP_depth_list": [_MLP_WIDTH, _MLP_WIDTH],
            "output_MLP_normalization_type": "NONE",
            "output_MLP_activation_type": "ReLU",
        },
    }


def _gnn_layer(index: int, auto_offset: bool):
    return {
        "scope": "layer%d" % index,
        "type": "scatter_max_graph_auto_center_net",
        "graph_level": 1,
        "kwargs": {
            "auto_offset": auto_offset,
            "auto_offset_MLP_depth_list": [64, 3],
            "auto_offset_MLP_normalization_type": "NONE",
            "auto_offset_MLP_feature_activation_type": "ReLU",
            "edge_MLP_depth_list": [_MLP_WIDTH, _MLP_WIDTH],
            "edge_MLP_normalization_type": "NONE",
            "edge_MLP_activation_type": "ReLU",
            "update_MLP_depth_list": [_MLP_WIDTH, _MLP_WIDTH],
            "update_MLP_normalization_type": "NONE",
            "update_MLP_activation_type": "ReLU",
        },
    }


def _predictor_layer():
    return {
        "scope": "output",
        "type": "classaware_predictor",
        "graph_level": 1,
        "kwargs": {
            "normalization_type": "NONE",
            "activation_type": "ReLU",
        },
    }


def layer_configs(T: int, auto_offset: bool = True) -> List[Dict]:
    """T = number of GraphNetAutoCenter iterations (T0..T3 family)."""
    layers = [_pooling_layer()]
    for t in range(T):
        layers.append(_gnn_layer(t + 2, auto_offset))
    layers.append(_predictor_layer())
    return layers


def _level_cfg(radius, num_neighbors, graph_level, graph_scale):
    return {
        "graph_gen_method": "disjointed_rnn_local_graph_v3",
        "graph_level": graph_level,
        "graph_scale": graph_scale,
        "graph_gen_kwargs": {
            "radius": radius,
            "num_neighbors": num_neighbors,
        },
    }


def model_config(
    label_method: str = "Car",
    T: int = 3,
    auto_offset: bool = True,
) -> Dict:
    """Full "config" dict (reference JSON schema)."""
    if label_method == "Car":
        num_classes = 4
        radii = (1.0, 4.0)
        train_scale, runtime_scale = 1, 0.5
        nms_thres = 0.01
    elif label_method == "Pedestrian_and_Cyclist":
        num_classes = 6
        radii = (0.4, 1.6)
        train_scale, runtime_scale = 0.5, 0.25
        nms_thres = 0.2
    elif label_method == "yaw":
        num_classes = 8
        radii = (1.0, 4.0)
        train_scale, runtime_scale = 1, 0.5
        nms_thres = 0.01
    else:
        raise ValueError(label_method)

    return {
        "model_name": "multi_layer_fast_local_graph_model_v2",
        "box_encoding_method": "classaware_all_class_box_encoding",
        "input_features": "i",
        "label_method": label_method,
        "num_classes": num_classes,
        "downsample_by_voxel_size": None,
        "nms_overlapped_thres": nms_thres,
        "loss": {
            "cls_loss_type": "softmax",
            "cls_loss_weight": 0.1,
            "loc_loss_weight": 10.0,
        },
        "graph_gen_method": "multi_level_local_graph_v3",
        "graph_gen_kwargs": {
            "base_voxel_size": 0.8,
            "add_rnd3d": True,
            "downsample_method": "random",
            "level_configs": [
                _level_cfg(radii[0], -1, 0, train_scale),
                _level_cfg(radii[1], 256, 1, train_scale),
            ],
        },
        "runtime_graph_gen_kwargs": {
            "base_voxel_size": 0.8,
            "add_rnd3d": False,
            "level_configs": [
                _level_cfg(radii[0], -1, 0, runtime_scale),
                _level_cfg(radii[1], -1, 1, runtime_scale),
            ],
        },
        "model_kwargs": {
            "layer_configs": layer_configs(T, auto_offset),
            "regularizer_type": "l1",
            "regularizer_kwargs": {"scale": 5e-7},
        },
        "eval_is_training": True,
    }


def train_config(
    label_method: str = "Car",
    train_dir: str = "./checkpoints/car_auto_T3_train",
    dataset_split: str = "train_car.txt",
) -> Dict:
    """Run hyperparameters ("train_config" schema) of the shipped car
    schedule: sgd, lr 0.125 with a staircase decay of 0.1 every 400K
    steps, batch 4."""
    max_steps = 1400000 if label_method == "Car" else 1000000
    return {
        "train_dataset": dataset_split,
        "train_dir": train_dir,
        "batch_size": 4,
        "NUM_GPU": 2,  # interpreted as data-parallel device count
        "unify_copies": True,
        "optimizer": "sgd",
        "optimizer_kwargs": {},
        "initial_lr": 0.125,
        "decay_step": 400000,
        "decay_factor": 0.1,
        "is_staircase": True,
        "max_epoch": 1718,
        "max_steps": max_steps,
        "save_every_epoch": 20,
        "NUM_TEST_SAMPLE": -1,
        "load_dataset_to_mem": True,
        "load_dataset_every_N_time": 0,
        "num_load_dataset_workers": 16,
        "capacity": 1,
        "visualization": False,
        "data_aug_configs": [
            {
                "method_name": "random_rotation_all",
                "method_kwargs": {
                    "method_name": "normal",
                    "yaw_std": 0.39269908169872414,
                    "expend_factor": [1.0, 1.0, 1.0],
                },
            },
            {
                "method_name": "random_flip_all",
                "method_kwargs": {"flip_prob": 0.5},
            },
            {
                "method_name": "random_box_shift",
                "method_kwargs": {
                    "method_name": "normal",
                    "xyz_std": [3, 0, 3],
                    "expend_factor": [1.1, 1.1, 1.1],
                    "max_overlap_num_allowed": 100,
                    "max_overlap_rate": 0.01,
                    "appr_factor": 10,
                    "max_trails": 100,
                },
            },
        ],
    }


def eval_config(label_method: str = "Car") -> Dict:
    """Evaluation settings ("eval_config" schema): the split to score,
    where to write the scalars, how often to poll the train_dir and the
    step at which to stop."""
    return {
        "eval_dataset": (
            "val_car.txt" if label_method == "Car" else "val_ped_cyl.txt"
        ),
        "eval_dir": "./checkpoints/eval",
        "NUM_TEST_SAMPLE": -1,
        "eval_every_second": 60,
        "max_step": 1400000 if label_method == "Car" else 1000000,
    }


def _named():
    return {
        "car_auto_T0_train": ("Car", 0, True),
        "car_auto_T1_train": ("Car", 1, True),
        "car_auto_T2_train": ("Car", 2, True),
        "car_auto_T3_train": ("Car", 3, True),
        "car_auto_T3_trainval": ("Car", 3, True),
        "car_fixed_T3_train": ("Car", 3, False),
        "ped_cyl_auto_T3_trainval": ("Pedestrian_and_Cyclist", 3, True),
    }


def get_config(name: str) -> Dict:
    label, T, auto = _named()[name]
    return model_config(label, T, auto)


def get_train_config(name: str) -> Dict:
    label, _, _ = _named()[name]
    split = "train_car.txt" if "train" in name else "trainval_car.txt"
    if label != "Car":
        split = "trainval_ped_cyl.txt"
    return train_config(label, "./checkpoints/%s" % name, split)


def list_configs():
    return sorted(_named())


def tpu_settings(name_or_label: str = "Car") -> Dict:
    """Static capacities and device-batch settings per config family."""
    label = name_or_label
    if name_or_label in _named():
        label = _named()[name_or_label][0]
    if label == "Pedestrian_and_Cyclist":
        cap = GraphCapacity(
            vertices=(32768, 16384, 16384), edges=(262144, 1048576)
        )
        runtime_cap = GraphCapacity(
            vertices=(49152, 24576, 24576), edges=(524288, 2097152)
        )
    else:
        cap = GraphCapacity(
            vertices=(32768, 12288, 12288), edges=(262144, 2097152)
        )
        runtime_cap = GraphCapacity(
            vertices=(49152, 20480, 20480), edges=(524288, 3145728)
        )
    return {
        "frame_capacity": cap,
        "runtime_capacity": runtime_cap,
        "frames_per_device": 2,
        # device-graph training compute precision; None = f32
        "compute_dtype": None,
    }
