"""The plain reference of the benchmark: a frozen float32 copy, in plain
PyTorch, of what the timed paths compute.

* `unet.py`: the diffusion UNet (diffusers UNet2DModel grammar, circular
  on azimuth), attention as a plain softmax;
* `vae.py`: the KL autoencoder's encoder and decoder (sgm grammar);
* `schedule.py`: the DDPM schedule, `add_noise`, the DDIM and
  DPM-Solver++(2M) updates and their sampling chains;
* `train.py`: the training step's loss, the global-norm clip, AdamW, the
  learning-rate warm-up and the EMA.

Every function takes its weights as a dict of tensors under the state-dict
names of the published checkpoints, so one dict of weights made from a
seed serves the program and the reference alike. Products run through a
`Precision` (`precision.py`): plain float32 for the reference, or float8
e4m3 on the operands of every convolution and product for the control.

Nothing here imports the program; TF32 must be off where this runs on the
card (`precision.strict_float32`).
"""
