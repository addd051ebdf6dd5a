"""The programs: pretraining (``pretrain``, with the train loop in
``common``), VCMR and VR finetuning (``train_vcmr``, ``train_vr``), VCMR
and VR serving (``eval_vcmr``, ``eval_vr``), and TVC finetuning and
captioning (``train_tvc``, ``inf_tvc``)."""
