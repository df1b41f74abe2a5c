"""Trajectory prediction (port of emloco_tpu/prediction): datasets, the
TransMotion and LSTM predictors, training with the EmLoco loss and
evaluation with the LocoVal filter."""
