"""Training: the counterpart of satae/train (losses, Adam, the train and eval
steps, the device-resident epoch bodies, the single-config trainers and the
frozen-encoder extraction)."""
